"""Whole-prompt prefill (``repro/serve/prefill.py``): one forward pass over
the (bucket-padded) prompt computes per layer

* K/V for every prompt position (padded positions zeroed);
* the landmark running sums ``q_lmk``/``k_lmk`` over the first ``n_valid``
  tokens with the cache's ``seq_max`` segment routing;
* the prompt's attention outputs, by ``prefill_impl``:
    - ``ss_fused``: exact masked attention for windows of at most c
      tokens, else ``ss_attention_fused`` (kernels K1 + K2) with
      ``kv_valid = n_valid`` so the pad never enters a softmax or a mean;
    - ``replay`` (and any prefill with ``decode_attention_impl="full"``):
      the decode attention of every position at once, against its own
      landmark prefix (``_prefix_sums``), as feeding the tokens one at a
      time would compute it; positions are a leading batch axis;
* the streaming decode state (m, l, acc): handed over from a second K1
  pass with the cache's landmark means and ``return_stats`` (ss_fused,
  windows longer than c), else recomputed in plain torch; zeros for
  ``decode_attention_impl="full"``, which keeps no stats.

MLA layers (``_mla_prefill``, ``_mla_chunk``) run the same routes absorbed:
keys are the rms-normed kv_lora latent beside the rotary key (576 wide at
DeepSeek-V2-Lite), broadcast to every query head before the kernels as
the reference broadcasts them, and the values the latents (512 wide); the
``moe`` family's feed-forward is ``moe_forward`` over the padded window
(its capacity counts the pad, as the reference's does).

Chunked prefill (``chunk_prefill``, ``prefill.py:627``) advances a lane by
one fixed-size chunk of its prompt at global positions start..: the chunk
attends with the exact replay math over the lane's committed keys plus
its own (so it equals whole-prompt ``replay`` prefill; kernel K2 never
runs here), the landmark sums continue the lane's, and the streaming
stats carry across chunks by flash-merge (``_merge_chunk_stats``), where
``stats_impl="ss_fused"`` streams each chunk window longer than c through
K1 with ``kv_valid = chunk_valid``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import full_attention
from repro_torch.kernels.ops import flash_merge, ss_attention_fused
from repro_torch.kernels.ss_attention import landmark_summary
from repro_torch.models.attention import (_broadcast_kv, gqa_project_qkv,
                                          mla_output, mla_project_kv,
                                          mla_project_q, mla_scale,
                                          output_projection, ss_config_from)
from repro_torch.models.layers import apply_rotary, mlp_forward, rms_norm, rotary_angles
from repro_torch.models.model import (_embed_tokens, _unembed, layer_params,
                                      torch_dtype, working_params)
from repro_torch.models.moe import moe_forward
from repro_torch.serve.decode import full_decode_attention, ss_decode_attention
from repro_torch.serve.decode_state import (STREAM_LEAVES, landmark_counts,
                                            landmark_means, mask_stats_rows,
                                            rebase_span, recompute_stats,
                                            segment_len)


def _routing(n: int, n_valid: int, seq_max: int, c: int, device):
    """(t_mask (n,), onehot (n, c)) segment routing of a prompt window, with
    positions >= n_valid zeroed (``prefill.py:102``)."""
    t = torch.arange(n, device=device)
    t_mask = t < n_valid
    oh = F.one_hot(t // segment_len(seq_max, c), c).float() * t_mask[:, None]
    return t_mask, oh


def _prefix_sums(oh: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-position inclusive landmark prefix sums (``prefill.py:112``):
    oh (n, c) masked routing, x (B, H, n, d) -> fp32 (n, B, H, c, d), entry
    t the running sums after tokens 0..t (what decode sees at position
    t)."""
    contrib = oh[None, None, :, :, None] * x.float()[:, :, :, None, :]
    return torch.cumsum(contrib, dim=2).permute(2, 0, 1, 3, 4)


def _landmark_sums(oh: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Landmark running sums after the whole window: oh (n, c) masked
    routing, x (B, H, n, d) -> fp32 (B, H, c, d), the last entry of
    ``_prefix_sums`` without the per-position ones."""
    return torch.einsum("nc,bhnd->bhcd", oh, x.float())


def prefill_supported(cfg: ModelConfig) -> bool:
    """Families whose whole decode state one forward pass derives
    (``prefill.py:89``). Hybrid and ssm stacks carry a recurrent state:
    they prefill by token replay through the decode step."""
    return cfg.family in ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig, what: str) -> None:
    """The reference's refusal (``prefill.py:355``, ``:655``) for a family
    without batched prefill. ``vlm`` prefills its text prompt as the dense
    family does."""
    if not prefill_supported(cfg):
        raise ValueError(f"{what} prefill unsupported for family {cfg.family}")


def _fused(cfg: ModelConfig, prefill_impl: str) -> bool:
    """Whether the prompt's attention runs the ss_fused branch (else the
    replay branch: ``prefill.py:146``)."""
    return prefill_impl == "ss_fused" and cfg.decode_attention_impl == "spectral_shift"


def _broadcast_sums(sums: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-position kv-head landmark sums (n, B, Hkv, c, d) broadcast to
    the query heads: (n, B, H, c, d)."""
    n, b, hkv = sums.shape[:3]
    return _broadcast_kv(sums.reshape(n * b, hkv, *sums.shape[3:]),
                         num_heads).reshape(n, b, num_heads, *sums.shape[3:])


def _attend_prefill(cfg: ModelConfig, prefill_impl: str, q, kb, vb, scale: float,
                    n_valid: int, seq_max: int, q_sums=None, k_sums_b=None,
                    pos0: int = 0):
    """Prompt attention (``prefill.py:123``). q (B, H, n, d); kb/vb
    kv-broadcast, pad-masked keys/values: the window itself, or for a
    chunk the lane's committed keys with the chunk's after them (longer
    than n); q_sums/k_sums_b the per-position landmark prefixes (n, B, H,
    c, d) that the replay branch of spectral shift reads; query t sits at
    global position ``pos0 + t``. Returns (B, H, n, dv)."""
    n = q.shape[2]
    if _fused(cfg, prefill_impl):
        if n <= cfg.num_landmarks:
            # Degenerate window: exact attention with the key-validity mask.
            key_mask = (torch.arange(n, device=q.device) < n_valid)[None, None, None, :]
            return full_attention(q, kb, vb, mask=key_mask, scale=scale)
        return ss_attention_fused(q, kb, vb, ss_config_from(cfg, causal=False),
                                  scale=scale, kv_valid=n_valid)
    # replay: every position's decode attention, positions leading
    qs = q.permute(2, 0, 1, 3)[:, :, :, None, :]            # (n, B, H, 1, d)
    pos = (pos0 + torch.arange(n, device=q.device))[:, None].expand(n, q.shape[0])
    if cfg.decode_attention_impl == "spectral_shift":
        outs = ss_decode_attention(qs, kb, vb, q_sums, k_sums_b, pos, cfg, scale,
                                   seq_max)
    else:
        outs = full_decode_attention(qs, kb, vb, pos, scale)
    return outs[:, :, :, 0].permute(1, 2, 0, 3)


def _seed_stream_stats(cfg: ModelConfig, prefill_impl: str, q_l, kb, vb,
                       n_valid: int, scale: float, seq_max: int):
    """Streaming decode state for one layer, seeded from the whole prompt
    (``prefill.py:174``): per-landmark partials (m, l, acc) over keys
    0..n_valid-1 keyed by the cache's landmark means q_l (B, H, c, d).
    ``ss_fused`` with a window longer than c runs K1 with ``return_stats``
    and rebuilds ``acc = BV * l`` from BV in v's dtype (that rounding is
    part of the reference's behaviour); other windows and ``replay``
    recompute in plain torch; ``decode_attention_impl="full"`` keeps zeros.
    Rows past the active segment are zeroed."""
    c = cfg.num_landmarks
    pos_last = n_valid - 1
    b, h, n, d = kb.shape
    dv = vb.shape[-1]
    if cfg.decode_attention_impl != "spectral_shift":
        z = torch.zeros((b, h, c, 1), dtype=torch.float32, device=kb.device)
        return z, z.clone(), torch.zeros((b, h, c, dv), dtype=torch.float32,
                                         device=kb.device)
    if prefill_impl == "ss_fused" and n > c:
        bv, m, l = landmark_summary(
            q_l.reshape(b * h, c, d).contiguous(),
            kb.reshape(b * h, n, d).contiguous(),
            vb.reshape(b * h, n, dv).contiguous(), scale=scale, return_stats=True,
            kv_valid=n_valid)
        m = m.reshape(b, h, c, 1)
        l = l.reshape(b, h, c, 1)
        acc = bv.float().reshape(b, h, c, dv) * l
    else:
        m, l, acc = recompute_stats(q_l, kb, vb, pos_last, scale)
    keep = torch.arange(c, device=kb.device) <= pos_last // segment_len(seq_max, c)
    return mask_stats_rows((m, l, acc), keep)


def _rope_dim(cfg: ModelConfig) -> int:
    """The rotary width: MLA's rope columns, else the head dim."""
    return cfg.rope_head_dim if cfg.mla else cfg.resolved_head_dim


def _gqa_prefill(p, cfg: ModelConfig, x, sin, cos, t_mask, oh, seq_max: int,
                 n_valid: int, prefill_impl: str):
    q, k, v = gqa_project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        q = apply_rotary(q, sin, cos)
        k = apply_rotary(k, sin, cos)
    pad = t_mask[None, None, :, None]
    k_m = torch.where(pad, k, 0).to(k.dtype)
    v_m = torch.where(pad, v, 0).to(v.dtype)
    # The kv heads broadcast to all query heads before the kernels, as the
    # reference does (7x the kv bytes at Qwen2-7B's 28/4 heads).
    kb = _broadcast_kv(k_m, cfg.num_heads)
    vb = _broadcast_kv(v_m, cfg.num_heads)

    q_sums = k_sums_b = None
    if not _fused(cfg, prefill_impl) and cfg.decode_attention_impl == "spectral_shift":
        # replay: every position's landmark prefix, and the cache's sums as
        # the last of them (fp32 (n, B, H, c, d): 0.44 GB a layer at 480
        # tokens of Qwen2-7B, freed with the layer)
        q_sums = _prefix_sums(oh, q)
        k_sums = _prefix_sums(oh, k_m)                      # (n, B, Hkv, c, d)
        q_sum, k_sum = q_sums[-1], k_sums[-1]
        k_sums_b = _broadcast_sums(k_sums, cfg.num_heads)
        del k_sums
    else:
        q_sum = _landmark_sums(oh, q)        # (B, H, c, d)
        k_sum = _landmark_sums(oh, k_m)      # (B, Hkv, c, d)

    scale = cfg.resolved_head_dim ** -0.5
    out = _attend_prefill(cfg, prefill_impl, q, kb, vb, scale, n_valid, seq_max,
                          q_sums, k_sums_b)
    del q_sums, k_sums_b
    c = cfg.num_landmarks
    counts = landmark_counts(torch.tensor([n_valid - 1], device=x.device),
                             seq_max, c)
    bv_m, bv_l, bv_acc = _seed_stream_stats(
        cfg, prefill_impl, landmark_means(q_sum, counts), kb, vb, n_valid, scale,
        seq_max)
    new_cache = {"k": k_m, "v": v_m, "q_lmk": q_sum, "k_lmk": k_sum,
                 "bv_m": bv_m, "bv_l": bv_l, "bv_acc": bv_acc}
    attn = output_projection(out.to(x.dtype), p["w_o"])
    return attn, new_cache


def _mla_kv(c_kv, k_rope, t_mask):
    """Pad-masked MLA cache rows and keys of a window: latent (B, 1, n, r),
    rope (B, 1, n, dr) and the absorbed keys (B, 1, n, de): one kv head."""
    pad = t_mask[None, :, None]
    lat = torch.where(pad, c_kv, 0).to(c_kv.dtype)[:, None]
    rope = torch.where(pad, k_rope, 0).to(k_rope.dtype)[:, None]
    return lat, rope, torch.cat([lat, rope], dim=-1)


def _mla_prefill(p, cfg: ModelConfig, x, sin, cos, t_mask, oh, seq_max: int,
                 n_valid: int, prefill_impl: str):
    """``prefill.py:261``: the absorbed keys and latent values broadcast to
    every head (materialized, as the reference's broadcast feeds its
    kernels), then the GQA prefill's attention and stats seed."""
    c_kv, k_rope = mla_project_kv(p, cfg, x, sin, cos)
    q_eff = mla_project_q(p, cfg, x, sin, cos)               # (B, H, n, de)
    lat, rope, k_eff = _mla_kv(c_kv, k_rope, t_mask)
    h = cfg.num_heads
    kb, vb = _broadcast_kv(k_eff, h), _broadcast_kv(lat, h)

    q_sums = k_sums_b = None
    if not _fused(cfg, prefill_impl) and cfg.decode_attention_impl == "spectral_shift":
        q_sums = _prefix_sums(oh, q_eff)
        k_sums = _prefix_sums(oh, k_eff)                     # (n, B, 1, c, de)
        q_sum, k_sum = q_sums[-1], k_sums[-1]
        k_sums_b = _broadcast_sums(k_sums, h)
        del k_sums
    else:
        q_sum = _landmark_sums(oh, q_eff)                    # (B, H, c, de)
        k_sum = _landmark_sums(oh, k_eff)                    # (B, 1, c, de)
    scale = mla_scale(cfg)
    out_lat = _attend_prefill(cfg, prefill_impl, q_eff, kb, vb, scale, n_valid,
                              seq_max, q_sums, k_sums_b)
    del q_sums, k_sums_b
    counts = landmark_counts(torch.tensor([n_valid - 1], device=x.device), seq_max,
                             cfg.num_landmarks)
    bv_m, bv_l, bv_acc = _seed_stream_stats(
        cfg, prefill_impl, landmark_means(q_sum, counts), kb, vb, n_valid, scale,
        seq_max)
    new_cache = {"latent": lat, "rope": rope, "q_lmk": q_sum, "k_lmk": k_sum,
                 "bv_m": bv_m, "bv_l": bv_l, "bv_acc": bv_acc}
    return mla_output(p, out_lat, x.dtype), new_cache


def _feed_forward(lp, cfg: ModelConfig, x):
    """The block's second half: x + MLP or MoE of its rms norm."""
    h = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
    if cfg.moe:
        ff, _ = moe_forward(lp["moe"], cfg, h)
    else:
        ff = mlp_forward(lp["mlp"], h, cfg.act)
    return x + ff


def _dense_layer_prefill(lp, cfg: ModelConfig, x, sin, cos, t_mask, oh,
                         seq_max: int, n_valid: int, prefill_impl: str):
    h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    fn = _mla_prefill if cfg.mla else _gqa_prefill
    attn, new_cache = fn(lp["attn"], cfg, h, sin, cos, t_mask, oh, seq_max, n_valid,
                         prefill_impl)
    return _feed_forward(lp, cfg, x + attn), new_cache


def batched_prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
                    n_valid: int, *, seq_max: int,
                    prefill_impl: str = "ss_fused"):
    """Run a whole (padded) prompt through the model in one pass
    (``prefill.py:335``). tokens (1, n_pad), ``n_valid`` <= n_pad real
    tokens. Returns ``(logits (1, n_pad, V), cache)`` with the reference's
    B=1 cache layout: ``cache["layers"][name]`` stacked (L, 1, ...), K/V
    zero past n_valid, ``cache["pos"] = n_valid``. The next-token logits
    are at index ``n_valid - 1``."""
    _check_family(cfg, "batched")
    if prefill_impl not in ("ss_fused", "replay"):
        raise ValueError(f"unknown prefill_impl {prefill_impl!r}")
    n = tokens.shape[1]
    n_valid = int(n_valid)
    if prefill_impl == "ss_fused" and n > cfg.num_landmarks and n_valid <= cfg.num_landmarks:
        raise ValueError(
            f"ss_fused prefill: prompt length {n_valid} <= num_landmarks "
            f"{cfg.num_landmarks} must run in a window of at most "
            f"num_landmarks tokens (the engine slices such prompts) — the "
            f"masked kernels model the > num_landmarks regime only")
    params = working_params(params, cfg)
    x = _embed_tokens(params, cfg, tokens).to(torch_dtype(cfg.compute_dtype))
    t_mask, oh = _routing(n, n_valid, seq_max, cfg.num_landmarks, x.device)
    positions = torch.arange(n, device=x.device)[None]
    sin, cos = rotary_angles(positions, _rope_dim(cfg), cfg.rope_theta)
    sin, cos = sin[:, None], cos[:, None]                   # (1, 1, n, dh/2)

    per_layer = []
    for i in range(cfg.num_layers):
        x, nc = _dense_layer_prefill(layer_params(params, i), cfg, x, sin, cos,
                                     t_mask, oh, seq_max, n_valid, prefill_impl)
        per_layer.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    layers = {name: torch.stack([nc[name] for nc in per_layer])
              for name in per_layer[0]}
    cache = {"pos": torch.tensor(n_valid, dtype=torch.int32, device=x.device),
             "layers": layers}
    return _unembed(params, cfg, x), cache


# --------------------------------------------------------------------------
# chunked prefill (continuous batching): one fixed-size prompt chunk per
# call, carrying the landmark state across chunks
# --------------------------------------------------------------------------
def _insert_chunk(view: torch.Tensor, chunk: torch.Tensor, start: int,
                  axis: int = 2) -> torch.Tensor:
    """A committed-prefix view (seq ``axis``) extended by one chunk
    (``prefill.py:411``): the view padded by the chunk's length with exact
    zeros, then the chunk's rows written at ``start``. The pad makes room
    for the whole chunk whatever ``start``, so the write never lands short
    of it (the reference's ``dynamic_update_slice`` never clamps)."""
    pad = list(view.shape)
    pad[axis] = chunk.shape[axis]
    ext = torch.cat([view.to(chunk.dtype), chunk.new_zeros(pad)], dim=axis)
    idx = [slice(None)] * view.dim()
    idx[axis] = slice(start, start + chunk.shape[axis])
    ext[tuple(idx)] = chunk
    return ext


def _merge_chunk_stats(cfg: ModelConfig, stats_impl: str, carry, q_l, kb, vb,
                       k_full_b, v_full_b, start: int, chunk_valid: int,
                       scale: float, seq_max: int):
    """Streaming-stat carry across prefill chunks for one layer
    (``prefill.py:425``). ``carry`` the lane's (bv_m, bv_l, bv_acc) after
    the previous chunk; ``q_l`` (B, H, c, d) the landmark means at ``end =
    start + chunk_valid``; kb/vb the chunk window's keys/values
    (head-broadcast, pad-masked); k_full_b/v_full_b the assembled keys
    0..end-1. Returns what whole-prompt seeding gives for a prompt of
    ``end`` tokens (frozen rows up to softmax reassociation):

    * rows frozen before the chunk (r < start // seg) merge the window's
      partial into the carry by ``flash_merge``; with ``stats_impl=
      "ss_fused"`` and a window longer than c the window runs through K1
      (``kv_valid = chunk_valid``), else ``recompute_stats``;
    * rows start // seg .. (end-1) // seg, whose means moved inside the
      chunk, are recomputed exactly over the assembled keys
      (``rebase_span``);
    * rows past the active segment stay zero."""
    c = cfg.num_landmarks
    if cfg.decode_attention_impl != "spectral_shift":
        return tuple(torch.zeros_like(s, dtype=torch.float32) for s in carry)
    seg = segment_len(seq_max, c)
    b, h, chunk_pad, d = kb.shape
    dv = vb.shape[-1]
    end_pos = start + chunk_valid - 1
    if stats_impl == "ss_fused" and chunk_pad > c:
        bv, m_w, l_w = landmark_summary(
            q_l.reshape(b * h, c, d).contiguous(),
            kb.reshape(b * h, chunk_pad, d).contiguous(),
            vb.reshape(b * h, chunk_pad, dv).contiguous(), scale=scale,
            return_stats=True, kv_valid=chunk_valid)
        m_w = m_w.reshape(b, h, c, 1)
        l_w = l_w.reshape(b, h, c, 1)
        acc_w = bv.float().reshape(b, h, c, dv) * l_w
    else:
        m_w, l_w, acc_w = recompute_stats(q_l, kb, vb, chunk_valid - 1, scale)
    carry32 = tuple(x.float() for x in carry)
    merged = flash_merge(*carry32, m_w, l_w, acc_w)
    frozen = (torch.arange(c, device=kb.device) < start // seg)[:, None]
    stats = tuple(torch.where(frozen, f, old) for f, old in zip(merged, carry32))
    row_hi = end_pos // seg
    stats = rebase_span(stats, q_l, k_full_b, v_full_b, end_pos, scale,
                        start // seg, row_hi)
    return mask_stats_rows(stats, torch.arange(c, device=kb.device) <= row_hi)


def _gqa_chunk(p, cfg: ModelConfig, x, sin, cos, t_mask, oh, seq_max: int,
               stats_impl: str, start: int, chunk_valid: int, lcache: dict):
    """One layer of a chunk (``prefill.py:488``). ``lcache`` the lane's
    B=1 leaves: ``k``/``v`` its committed keys (1, Hkv, >= start, Dh), the
    rest as carried from the previous chunk."""
    q, k, v = gqa_project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        q = apply_rotary(q, sin, cos)
        k = apply_rotary(k, sin, cos)
    pad = t_mask[None, None, :, None]
    k_m = torch.where(pad, k, 0).to(k.dtype)
    v_m = torch.where(pad, v, 0).to(v.dtype)

    # landmark prefixes continue the lane's running sums
    q_sums = lcache["q_lmk"].float()[None] + _prefix_sums(oh, q)
    k_sums = lcache["k_lmk"].float()[None] + _prefix_sums(oh, k_m)
    kb = _broadcast_kv(k_m, cfg.num_heads)
    vb = _broadcast_kv(v_m, cfg.num_heads)
    k_sums_b = _broadcast_sums(k_sums, cfg.num_heads)
    # assembled keys 0..end-1: committed view + this chunk at [start, end)
    kfb = _broadcast_kv(_insert_chunk(lcache["k"], k_m, start), cfg.num_heads)
    vfb = _broadcast_kv(_insert_chunk(lcache["v"], v_m, start), cfg.num_heads)

    scale = cfg.resolved_head_dim ** -0.5
    out = _attend_prefill(cfg, "replay", q, kfb, vfb, scale, chunk_valid, seq_max,
                          q_sums, k_sums_b, pos0=start)
    del k_sums_b
    c = cfg.num_landmarks
    counts = landmark_counts(torch.tensor([start + chunk_valid - 1], device=x.device),
                             seq_max, c)
    q_l = landmark_means(q_sums[-1], counts)
    bv_m, bv_l, bv_acc = _merge_chunk_stats(
        cfg, stats_impl, tuple(lcache[name] for name in STREAM_LEAVES), q_l, kb,
        vb, kfb, vfb, start, chunk_valid, scale, seq_max)
    new_cache = {"k": k_m, "v": v_m, "q_lmk": q_sums[-1], "k_lmk": k_sums[-1],
                 "bv_m": bv_m, "bv_l": bv_l, "bv_acc": bv_acc}
    attn = output_projection(out.to(x.dtype), p["w_o"])
    return attn, new_cache


def _mla_chunk(p, cfg: ModelConfig, x, sin, cos, t_mask, oh, seq_max: int,
               stats_impl: str, start: int, chunk_valid: int, lcache: dict):
    """One MLA layer of a chunk (``prefill.py:541``). ``lcache`` the lane's
    B=1 leaves: ``latent``/``rope`` its committed rows (1, 1, >= start,
    r|dr), the rest as carried from the previous chunk."""
    c_kv, k_rope = mla_project_kv(p, cfg, x, sin, cos)
    q_eff = mla_project_q(p, cfg, x, sin, cos)
    lat, rope, k_eff = _mla_kv(c_kv, k_rope, t_mask)
    h = cfg.num_heads

    q_sums = lcache["q_lmk"].float()[None] + _prefix_sums(oh, q_eff)
    k_sums = lcache["k_lmk"].float()[None] + _prefix_sums(oh, k_eff)
    kb, vb = _broadcast_kv(k_eff, h), _broadcast_kv(lat, h)
    k_sums_b = _broadcast_sums(k_sums, h)
    # assembled keys 0..end-1: committed rows + this chunk at [start, end)
    lat_full = _insert_chunk(lcache["latent"], lat, start)
    kfb = _broadcast_kv(torch.cat([lat_full, _insert_chunk(lcache["rope"], rope, start)],
                                  dim=-1), h)
    vfb = _broadcast_kv(lat_full, h)

    scale = mla_scale(cfg)
    out_lat = _attend_prefill(cfg, "replay", q_eff, kfb, vfb, scale, chunk_valid,
                              seq_max, q_sums, k_sums_b, pos0=start)
    del k_sums_b
    counts = landmark_counts(torch.tensor([start + chunk_valid - 1], device=x.device),
                             seq_max, cfg.num_landmarks)
    q_l = landmark_means(q_sums[-1], counts)
    bv_m, bv_l, bv_acc = _merge_chunk_stats(
        cfg, stats_impl, tuple(lcache[name] for name in STREAM_LEAVES), q_l, kb,
        vb, kfb, vfb, start, chunk_valid, scale, seq_max)
    new_cache = {"latent": lat, "rope": rope, "q_lmk": q_sums[-1], "k_lmk": k_sums[-1],
                 "bv_m": bv_m, "bv_l": bv_l, "bv_acc": bv_acc}
    return mla_output(p, out_lat, x.dtype), new_cache


def _dense_layer_chunk(lp, lcache, cfg: ModelConfig, x, sin, cos, t_mask, oh,
                       seq_max: int, stats_impl: str, start: int, chunk_valid: int):
    h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    fn = _mla_chunk if cfg.mla else _gqa_chunk
    attn, new_cache = fn(lp["attn"], cfg, h, sin, cos, t_mask, oh, seq_max,
                         stats_impl, start, chunk_valid, lcache)
    return _feed_forward(lp, cfg, x + attn), new_cache


def chunk_prefill(params, cfg: ModelConfig, cache: dict, tokens: torch.Tensor,
                  start: int, chunk_valid: int, *, seq_max: int,
                  stats_impl: str = "replay"):
    """Advance a mid-prefill lane by one fixed-size prompt chunk
    (``prefill.py:627``). ``cache["layers"]`` the lane's B=1 view, stacked
    (L, 1, ...): committed K/V for positions < ``start`` and the dense
    landmark / stream leaves carried from the previous chunk. ``tokens``
    (1, chunk_pad) hold ``chunk_valid`` real tokens at global positions
    start..start+chunk_valid-1 (host ints). Returns ``(logits (1,
    chunk_pad, V), cache)``: K/V leaves hold the CHUNK's K/V only (the
    caller commits them to the chunk's blocks), the other leaves the
    carried-forward state; the next-token logits are at ``chunk_valid -
    1``. Chunk attention is the exact replay math, so chunked prefill
    equals whole-prompt ``replay`` prefill; ``stats_impl`` routes only
    the stats handoff."""
    _check_family(cfg, "chunked")
    params = working_params(params, cfg)
    start, chunk_valid = int(start), int(chunk_valid)
    n = tokens.shape[1]
    x = _embed_tokens(params, cfg, tokens).to(torch_dtype(cfg.compute_dtype))
    c = cfg.num_landmarks
    t = torch.arange(n, device=x.device)
    t_mask = t < chunk_valid
    # pad positions may lie past the horizon's last segment: routed nowhere
    seg_idx = torch.clamp((start + t) // segment_len(seq_max, c), max=c - 1)
    oh = F.one_hot(seg_idx, c).float() * t_mask[:, None]
    sin, cos = rotary_angles((start + t)[None], _rope_dim(cfg), cfg.rope_theta)
    sin, cos = sin[:, None], cos[:, None]

    layers = cache["layers"]
    per_layer = []
    for i in range(cfg.num_layers):
        lcache = {name: leaf[i] for name, leaf in layers.items()}
        x, nc = _dense_layer_chunk(layer_params(params, i), lcache, cfg, x, sin, cos,
                                   t_mask, oh, seq_max, stats_impl, start, chunk_valid)
        per_layer.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_layers = {name: torch.stack([nc[name] for nc in per_layer])
                  for name in per_layer[0]}
    return _unembed(params, cfg, x), {"pos": start + chunk_valid, "layers": new_layers}


def make_chunk_prefill_fn(params, cfg: ModelConfig, *, seq_max: int,
                          stats_impl: str = "replay"):
    """Chunk-prefill closure ``fn(cache, tokens, start, chunk_valid)`` for
    ``PagedKVCache.make_chunk_step`` (``prefill.py:702``)."""
    def fn(cache, tokens, start, chunk_valid):
        return chunk_prefill(params, cfg, cache, tokens, start, chunk_valid,
                             seq_max=seq_max, stats_impl=stats_impl)

    return fn
