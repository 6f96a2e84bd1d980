"""Streaming decode state: per-landmark online-softmax stats in the cache
(``repro/serve/decode_state.py``).

The cache carries, per landmark row r, the partial state
``bv_m`` (m_r), ``bv_l`` (l_r = sum_j exp(s_rj - m_r)) and ``bv_acc``
(sum_j exp(s_rj - m_r) v_j), so ``BV[r] = acc_r / l_r``. Each decode tick
flash-appends the new key/value to every reached row. The active segment's
row, whose landmark mean still moves with each token, is handled by
``ModelConfig.decode_streaming``:

* ``"exact"``: recomputed exactly every tick through the
  ``active_stats_fn`` hook, which the paged route backs with kernel K5
  and the gather route with a recompute over its dense views;
* ``"frozen"``: streamed like the others (each key scored with the mean
  current when it was appended), and rebased (recomputed exactly) when a
  lane's write position crosses a segment boundary: ``rebase_layer``,
  which the engine runs through ``PagedKVCache.make_rebase_step``. A
  frozen tick reads no key or value of the horizon.

Lanes are the batch axis B and each lane has its own position, so
``pos`` is a (B,) tensor and every landmark count, mask and active-row
index below is per lane.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.attention import NEG_INF
from repro_torch.core.landmarks import segment_counts
from repro_torch.core.spectral_shift import ss_core
from repro_torch.kernels.ops import flash_merge
from repro_torch.models.attention import _broadcast_kv, mla_scale

STREAM_LEAVES = ("bv_m", "bv_l", "bv_acc")


def segment_len(seq_max: int, c: int) -> int:
    return -(-seq_max // c)


def landmark_counts(pos: torch.Tensor, seq_max: int, c: int) -> torch.Tensor:
    """Tokens accumulated per landmark after ``pos+1`` tokens: (B, c) fp32
    for pos (B,); zero for segments not yet reached."""
    return segment_counts(pos.long() + 1, c, segment_len(seq_max, c), floor=0)


def lmk_add(sums: torch.Tensor, value: torch.Tensor, pos: torch.Tensor,
            seq_max: int) -> torch.Tensor:
    """sums (B, X, c, d) + value (B, X, d) routed to segment(pos) per lane,
    accumulated in fp32 (``decode_state.py:81``)."""
    c = sums.shape[-2]
    seg = pos.long() // segment_len(seq_max, c)
    onehot = F.one_hot(seg, c).float()                      # (B, c)
    add = onehot[:, None, :, None] * value.float()[:, :, None, :]
    return sums + add.to(sums.dtype)


def landmark_means(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """fp32 means of running sums (..., B, X, c, d) with per-lane counts
    (..., B, c); empty segments divide by 1."""
    return sums.float() / torch.clamp(counts, min=1.0)[..., None, :, None]


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    scores = torch.where(mask, scores.float(), NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def stream_append(stats, q_l, k_new, v_new, scale: float, row_mask=None):
    """Flash-append one key/value to every landmark row's partial state.
    stats (m, l, acc) (B, H, c, 1)/(B, H, c, 1)/(B, H, c, dv); q_l
    (B, H, c, d) fp32; k_new (B, H, d); v_new (B, H, dv); ``row_mask``
    (B, c) keeps rows of segments not yet reached untouched."""
    m, l, acc = (x.float() for x in stats)
    s = torch.einsum("bhcd,bhd->bhc", q_l, k_new.float())[..., None] * scale
    m_n, l_n, acc_n = flash_merge(m, l, acc, s, torch.ones_like(s),
                                  v_new[:, :, None, :].float())
    if row_mask is not None:
        rm = row_mask[:, None, :, None]
        m_n = torch.where(rm, m_n, m)
        l_n = torch.where(rm, l_n, l)
        acc_n = torch.where(rm, acc_n, acc)
    return m_n, l_n, acc_n


def key_mask(n: int, pos, device) -> torch.Tensor:
    """Keys 0..pos of a view of n keys: (1, 1, 1, n) for an int ``pos``,
    (..., B, 1, 1, n) for a tensor of per-lane positions (..., B)."""
    keys = torch.arange(n, device=device)
    if isinstance(pos, torch.Tensor):
        return (keys <= pos.long()[..., None])[..., None, None, :]
    return (keys <= pos)[None, None, None, :]


def recompute_stats(q_l, k, v, pos, scale: float, row_valid=None):
    """Exact (m, l, acc) of ``softmax(scale * q_l . K[0..pos])`` rows:
    q_l (B, X, R, d); k/v (B, X, S, d/dv); keys past ``pos`` (an int, or
    per lane (B,)) masked (``decode_state.py:132``). Prefill seeds its
    streaming state with it; the gather route's exact decode recomputes
    the active row with it, the query heads grouped onto the kv heads.
    ``row_valid`` (B, R) bool zeroes the rows of segments not yet reached
    (the streaming invariant)."""
    s = torch.einsum("bhcd,bhsd->bhcs", q_l.float(), k.float()) * scale
    key_mask_ = key_mask(k.shape[2], pos, k.device)
    s = torch.where(key_mask_, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(key_mask_, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhcs,bhsd->bhcd", p, v.float())
    if row_valid is not None:
        rv = row_valid[:, None, :, None]
        m, l, acc = (torch.where(rv, x, 0.0) for x in (m, l, acc))
    return m, l, acc


def rebase_span(stats, q_l, k, v, pos: int, scale: float, row_lo: int,
                row_hi: int):
    """Exactly recompute landmark rows ``row_lo..row_hi`` (host ints,
    clipped to c) over keys 0..pos; other rows pass through unchanged
    (``decode_state.py:173``; the reference scatters a static window of
    rows through a masked one-hot, here the rows are sliced). stats (m, l,
    acc) (B, H, c, 1|dv); q_l (B, H, c, d); k/v (B, H, S, d/dv)."""
    c = q_l.shape[2]
    lo, hi = row_lo, min(row_hi, c - 1) + 1
    out = tuple(x.float().clone() for x in stats)
    if lo < hi:
        fresh = recompute_stats(q_l[:, :, lo:hi], k, v, pos, scale)
        for dst, src in zip(out, fresh):
            dst[:, :, lo:hi] = src
    return out


def rebase_rows(stats, q_l, k, v, pos, scale: float, rows: torch.Tensor):
    """Exactly recompute the partial state of the distinct landmark rows
    ``rows`` ((R,), or (B, R): per lane) over keys 0..pos (an int, or per
    lane (B,)); other rows pass through unchanged (``decode_state.py:155``).
    stats (m, l, acc) (B, H, c, 1|dv); q_l (B, H, c, d); k/v (B, Hkv, S,
    d/dv) with Hkv dividing H: each query head's rows are scored against
    its kv head, as the reference's ``_broadcast_kv`` pairs them, without
    a head-broadcast copy of the horizon."""
    b, h, c, d = q_l.shape
    hkv = k.shape[1]
    rows = rows.long().expand(b, -1) if rows.dim() == 1 else rows.long()
    r = rows.shape[1]
    sel = rows[:, None, :, None]                            # (B, 1, R, 1)
    q_sel = torch.gather(q_l, 2, sel.expand(b, h, r, d))    # (B, H, R, d)
    fresh = recompute_stats(q_sel.reshape(b, hkv, (h // hkv) * r, d), k, v, pos,
                            scale)
    out = []
    for old, new in zip(stats, fresh):
        new = new.reshape(b, h, r, new.shape[-1])
        out.append(old.float().scatter(2, sel.expand(b, h, r, new.shape[-1]), new))
    return tuple(out)


def mask_stats_rows(stats, keep: torch.Tensor):
    """Zero the partial state of rows where ``keep`` (c,) is False."""
    km = keep[:, None]
    return tuple(torch.where(km, x, 0.0) for x in stats)


# --------------------------------------------------------------------------
# Prefix-cache attach (``decode_state.py:417-519``): landmark-sum
# re-segmentation and the full stats reseed of ``prefix_attach="recompute"``.
# --------------------------------------------------------------------------
def resegment_sums(sums: torch.Tensor, seg_from: int, seg_to: int) -> torch.Tensor:
    """Re-segment per-landmark running sums (..., c, d) from segment length
    ``seg_from`` to ``seg_to`` (``decode_state.py:417``): target row t sums
    source rows t*m..(t+1)*m-1, m = seg_to / seg_from. Exact only when
    every target window is a union of source windows; anything else
    raises."""
    if seg_to == seg_from:
        return sums
    if seg_to % seg_from:
        raise ValueError(
            f"cannot re-segment sums from segment length {seg_from} to "
            f"{seg_to}: target windows must be unions of source windows "
            f"(seg_to % seg_from == 0)")
    c = sums.shape[-2]
    m = seg_to // seg_from
    idx = torch.arange(c, device=sums.device)
    route = ((idx[:, None] // m) == idx[None, :]).float()   # (c_src, c_tgt)
    return torch.einsum("sc,...sd->...cd", route, sums.float()).to(sums.dtype)


def layer_keys(cfg, lcache: dict):
    """A layer's keys, values and score scale from its dense views: GQA's
    ``k``/``v`` (B, Hkv, S, Dh) at 1 / sqrt(Dh); MLA's absorbed keys, the
    ``latent`` and ``rope`` rows side by side (B, 1, S, de), with the
    latents as values, at 1 / sqrt(dh + dr) (the ``mla`` branches of
    ``_rebase_attn_layer`` :335 and ``_reseed_attn_layer`` :455)."""
    if cfg.mla:
        return (torch.cat([lcache["latent"], lcache["rope"]], dim=-1),
                lcache["latent"], mla_scale(cfg))
    return lcache["k"], lcache["v"], cfg.resolved_head_dim ** -0.5


def reseed_layer(cfg, lcache: dict, pos, seq_max: int) -> dict:
    """Re-found one layer's streaming state (``_reseed_attn_layer``
    :443): recompute every reached row's (m, l, acc) exactly over keys
    0..pos. ``lcache`` holds lane-batched leaves: the sequence leaves as
    dense views (B, Hkv, S, D), the rest (B, ...); ``pos`` (B,) the index
    of each lane's last attached token."""
    c = cfg.num_landmarks
    counts = landmark_counts(pos, seq_max, c)
    q_l = landmark_means(lcache["q_lmk"], counts)
    k, v, scale = layer_keys(cfg, lcache)
    m, l, acc = recompute_stats(
        q_l, _broadcast_kv(k, cfg.num_heads), _broadcast_kv(v, cfg.num_heads), pos,
        scale, row_valid=counts > 0)
    return dict(lcache, bv_m=m, bv_l=l, bv_acc=acc)


def rebase_layer(cfg, lcache: dict, pos, seq_max: int) -> dict:
    """The frozen-mode boundary rebase of one layer (``_rebase_attn_layer``
    :327). ``pos`` (B,) is each lane's boundary position just written (pos
    % seg == 0, pos > 0): row active - 1 just froze with its final landmark
    mean, so it is recomputed to clear the drift its active phase gathered,
    and row active is founded over keys 0..pos so later appends extend an
    exact base. ``lcache`` as ``reseed_layer`` takes it."""
    c = cfg.num_landmarks
    counts = landmark_counts(pos, seq_max, c)
    q_l = landmark_means(lcache["q_lmk"], counts)
    active = pos.long() // segment_len(seq_max, c)
    rows = torch.stack([torch.clamp(active - 1, min=0), active], dim=1)
    k, v, scale = layer_keys(cfg, lcache)
    m, l, acc = rebase_rows(tuple(lcache[name] for name in STREAM_LEAVES), q_l,
                            k, v, pos, scale, rows)
    return dict(lcache, bv_m=m, bv_l=l, bv_acc=acc)


def make_rebase_fn(cfg, seq_max: int):
    """Boundary-rebase closure ``fn(layers, pos) -> layers`` over a list of
    per-layer lane-batched caches (``make_rebase_fn`` :385, with
    ``rebase_streaming`` :362's walk over the layers), for
    ``PagedKVCache.make_rebase_step``."""

    def fn(layers, pos):
        return [rebase_layer(cfg, lc, pos, seq_max) for lc in layers]

    return fn


def make_reseed_fn(cfg, seq_max: int):
    """Attach-reseed closure ``fn(layers, pos) -> layers`` over a list of
    per-layer lane-batched caches (``make_reseed_fn`` :509), for
    ``PagedKVCache.make_rebase_step``."""

    def fn(layers, pos):
        return [reseed_layer(cfg, lc, pos, seq_max) for lc in layers]

    return fn


def ss_decode_attention_streaming(q, k_new, v_new, q_lmk_sum, k_lmk_sum,
                                  stats, pos, cfg, scale: float, seq_max: int,
                                  active_stats_fn=None):
    """One spectral-shift decode step with streamed B-side state
    (``decode_state.py:217``), in ``cfg.decode_streaming``'s mode.

    q (B, H, 1, d); k_new/v_new (B, H, d) this tick's key/value (heads
    broadcast); q_lmk_sum/k_lmk_sum (B, H, c, d) updated running sums;
    stats the pre-append (bv_m, bv_l, bv_acc); pos (B,) the current token's
    index per lane. In ``"exact"`` mode ``active_stats_fn(q_act (B, H, 1,
    d))`` returns the exact partials of the active landmark row over keys
    0..pos: K5 over the pools on the paged route, ``recompute_stats`` over
    the dense views on the gather route (``serve/decode.py``). A
    ``"frozen"`` step streams the active row too and takes no hook: it
    reads nothing of the horizon. Returns ``(out (B, H, 1, dv), (m, l,
    acc))``."""
    mode = cfg.decode_streaming
    if mode not in ("exact", "frozen"):
        raise ValueError(f"unknown decode_streaming mode {mode!r}; want 'exact' or "
                         f"'frozen' (or route 'recompute' to ss_decode_attention)")
    if mode == "exact" and active_stats_fn is None:
        raise ValueError("exact mode needs active_stats_fn")
    b, h, c, d = q_lmk_sum.shape
    counts = landmark_counts(pos, seq_max, c)
    valid = counts > 0                                      # (B, c)
    q_l = landmark_means(q_lmk_sum, counts)
    k_l = landmark_means(k_lmk_sum, counts)

    f = masked_softmax(
        torch.einsum("bhqd,bhcd->bhqc", q.float(), k_l) * scale,
        valid[:, None, None, :],
    )                                                       # (B, H, 1, c)
    a_mask = valid[:, None, :, None] & valid[:, None, None, :]
    a_raw = masked_softmax(torch.einsum("bhcd,bhed->bhce", q_l, k_l) * scale,
                           a_mask)
    eye = torch.eye(c, dtype=torch.float32, device=q.device)
    a = torch.where(a_mask, a_raw, eye)   # invalid block pinned to identity
    core = ss_core(a, method="iterative", pinv_iters=cfg.pinv_iters,
                   use_shift=cfg.include_shift_identity)

    rows = torch.arange(c, device=q.device)
    active = pos.long() // segment_len(seq_max, c)          # (B,)
    m, l, acc = stream_append(stats, q_l, k_new, v_new, scale,
                              row_mask=rows[None, :] <= active[:, None])
    if mode == "exact":
        # The active segment's mean moved with this token: recompute that row.
        q_act = torch.gather(q_l, 2, active[:, None, None, None].expand(b, h, 1, d))
        m_a, l_a, acc_a = active_stats_fn(q_act)
        hit = (rows[None, :] == active[:, None])[:, None, :, None]  # (B, 1, c, 1)
        m = torch.where(hit, m_a, m)
        l = torch.where(hit, l_a, l)
        acc = torch.where(hit, acc_a, acc)

    bv = acc / torch.clamp(l, min=1e-30)
    out = torch.einsum("bhqc,bhcd->bhqd", f,
                       torch.einsum("bhce,bhed->bhcd", core.u, bv))
    if cfg.include_shift_identity:
        out = out + core.delta * v_new[:, :, None, :].float()
    return out.to(q.dtype), (m, l, acc)
