"""One decode step for every lane at once, spectral-shift decode attention
(``repro/serve/decode.py``), on either of the reference's two routes.

Lanes are the batch axis: ``decode_step`` takes tokens (B, 1) and
positions (B,). Each layer returns the NEW token's K/V (B, Hkv, 1, Dh) in
place of the sequence-shaped leaves, for the caller to commit after the
step (``PagedKVCache.make_paged_step`` / ``make_fused_step``).

* The paged route (``paged_table`` given): the sequence-shaped leaves are
  the shared block pools, read only through kernel K5 (launched once per
  layer for all lanes), which sees keys 0..pos-1; the current token is
  flash-merged on top.
* The gather route: the sequence-shaped leaves are dense per-lane views
  (B, Hkv, S, Dh), gathered from the pools or the lane-dense storage
  itself; the current token is written into a copy of the view at
  ``pos`` (``_update_seq``) and attention reads the view. It serves every
  ``decode_streaming`` mode: exact (the active row recomputed over the
  view), frozen, and recompute (``ss_decode_attention``, the whole
  landmark-to-key softmax rebuilt each tick), which only this route
  serves.

MLA layers (``mla_decode``) decode absorbed: attention runs over the
(kv_lora + rope) keys with the latents as values, one kv head for all
query heads; on the paged route K5 reads the latent and rope pools as two
key pools, the latent pool also the value pool.

The ``moe`` family's feed-forward is ``models/moe.py``'s ``moe_forward``,
routed per lane (each lane is its own batch row, so lanes never share
capacity).

Hybrid (Hymba) layers (``_hymba_layer_decode``) run ``gqa_decode`` on the
layer's attention leaves and ``mamba_decode`` (one step of the selective
SSM and its causal conv) on its mamba leaves ``ssm_h`` / ``conv``, which
are lane-dense on both routes; the engine's storage holds both groups
under their leaf names, and a layer's new leaves come back in one dict.

xLSTM blocks (the ``ssm`` family: ``mlstm_block_decode``,
``slstm_block_decode``) step their recurrent cells on lane-dense state
alone; no leaf has a sequence axis and no kernel runs.

Whisper's decoder (``_whisper_decode``) runs ``gqa_decode`` on each
layer's self-attention leaves (K5 on the paged route), then cross
attention as an fp32 softmax over all 1500 rows of the layer's
``cross_k`` / ``cross_v``, which serving leaves at zero, as the
reference's engine does; its learned positions are clamped at row 4095.

A ``decode_streaming="frozen"`` step reads neither the pools nor a view
for its spectral-shift core on either route (K5 never launches): it
touches the lane-dense state and the new token only. The engine rebases
the frozen rows at segment boundaries (``decode_state.rebase_layer``).

Cache layout consumed here: ``cache["pos"]`` (B,) int32 and
``cache["layers"]``, keyed as the engine's storage
(``kv_cache.storage_layout``; ``kv_cache.layer_leaves`` picks a layer's
leaves), with the sequence leaves (``k``/``v``, or MLA's
``latent``/``rope`` with a unit kv-head axis) either pools (L, Hkv,
num_blocks, bs, D) or views (L, B, Hkv, S, D), and lane-dense leaves
(L, B, ...) (``serve/kv_cache.py`` for the names).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.spectral_shift import ss_core
from repro_torch.kernels.ops import flash_merge
from repro_torch.kernels.paged_decode import paged_row_stats_lanes
from repro_torch.models.attention import (_broadcast_kv, gqa_project_qkv,
                                          mla_output, mla_project_kv,
                                          mla_project_q, mla_scale,
                                          output_projection, project_heads)
from repro_torch.models.layers import (apply_rotary, gelu, layer_norm, mlp_forward,
                                       rms_norm, rotary_angles)
from repro_torch.models.model import (_embed_tokens, _unembed, layer_params,
                                      torch_dtype, working_params)
from repro_torch.models.moe import moe_forward
from repro_torch.models.ssm import mlstm_step, slstm_cell
from repro_torch.serve.decode_state import (STREAM_LEAVES, key_mask,
                                            landmark_counts, landmark_means,
                                            lmk_add, masked_softmax,
                                            recompute_stats,
                                            ss_decode_attention_streaming)
from repro_torch.serve.kv_cache import MAMBA_LEAVES, layer_leaves

DENSE_LEAVES = ("q_lmk", "k_lmk", *STREAM_LEAVES)


# --------------------------------------------------------------------------
# Attention over dense views (the gather route and the replay prefill). A
# leading axis (...) ahead of the lanes batches query positions: the replay
# prefill passes (n, B), one decode step none.
# --------------------------------------------------------------------------
def _rows_at(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Row ``pos`` of each lane's view: x (B, H, S, e), pos (..., B) ->
    (..., B, H, 1, e)."""
    b, h, _, e = x.shape
    idx = pos.long()[..., None, None, None].expand(*pos.shape, h, 1, e)
    return torch.gather(x.expand(*pos.shape[:-1], *x.shape), -2, idx)


def ss_decode_attention(q, k_cache, v_cache, q_lmk_sum, k_lmk_sum, pos,
                        cfg: ModelConfig, scale: float, seq_max: int):
    """Spectral-shift decode attention with the B-side softmax rebuilt over
    the whole view (``decode.py:84``, ``decode_streaming="recompute"``):

        out = F U_ss (B V) + delta * v_pos

    q (..., B, H, 1, d); k_cache/v_cache (B, H, S, d/dv) kv-broadcast views
    holding the current token at ``pos``; q_lmk_sum/k_lmk_sum (..., B, H,
    c, d) the running sums after it; pos (..., B) the current token's
    index. Landmark segments come from ``seq_max``, not the view length.
    Empty landmarks are masked out of F and B and pinned to identity in A.
    Returns (..., B, H, 1, dv) in q's dtype."""
    c = q_lmk_sum.shape[-2]
    counts = landmark_counts(pos, seq_max, c)                # (..., B, c)
    valid = counts > 0
    q_l = landmark_means(q_lmk_sum, counts)
    k_l = landmark_means(k_lmk_sum, counts)
    kt = k_l.transpose(-1, -2)
    f = masked_softmax(q.float() @ kt * scale, valid[..., None, None, :])
    a_mask = valid[..., None, :, None] & valid[..., None, None, :]
    a_raw = masked_softmax(q_l @ kt * scale, a_mask)
    eye = torch.eye(c, dtype=torch.float32, device=q.device)
    a = torch.where(a_mask, a_raw, eye)   # invalid block pinned to identity
    b_mat = masked_softmax(q_l @ k_cache.float().transpose(-1, -2) * scale,
                           key_mask(k_cache.shape[2], pos, q.device))
    core = ss_core(a, method="iterative", pinv_iters=cfg.pinv_iters,
                   use_shift=cfg.include_shift_identity)
    bv = b_mat @ v_cache.float()                             # (..., B, H, c, dv)
    out = f @ (core.u @ bv)
    if cfg.include_shift_identity:
        out = out + core.delta * _rows_at(v_cache, pos).float()
    return out.to(q.dtype)


def full_decode_attention(q, k_cache, v_cache, pos, scale: float):
    """Exact decode attention over the view's keys 0..pos (``decode.py:141``).
    q (..., B, H, 1, d); k_cache/v_cache (B, H, S, d/dv); pos (..., B)."""
    scores = q.float() @ k_cache.float().transpose(-1, -2) * scale
    p = masked_softmax(scores, key_mask(k_cache.shape[2], pos, q.device))
    return (p @ v_cache.float()).to(q.dtype)


def _update_seq(view: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """A copy of the view (B, H, S, D) with the token new (B, H, 1, D) at
    each lane's ``pos`` (``decode.py:221``)."""
    out = view.clone()
    out[torch.arange(view.shape[0], device=view.device), :, pos.long()] = (
        new[:, :, 0].to(view.dtype))
    return out


def _view_active_stats_fn(k_view, v_view, pos, scale: float):
    """``active_stats_fn`` hook of the gather route: the active landmark row
    of each query head, grouped onto its kv head, recomputed exactly over
    the lane's view (which holds the current token)."""
    hkv = k_view.shape[1]

    def fn(q_act):  # (B, H, 1, d)
        b, h = q_act.shape[:2]
        q_g = q_act.reshape(b, hkv, h // hkv, q_act.shape[-1])
        m, l, acc = recompute_stats(q_g, k_view, v_view, pos, scale)
        return (m.reshape(b, h, 1, 1), l.reshape(b, h, 1, 1),
                acc.reshape(b, h, 1, acc.shape[-1]))

    return fn


# --------------------------------------------------------------------------
# Gather-free reads of the block pools through kernel K5.
# --------------------------------------------------------------------------
def _paged_merged_stats(q_g, k_pools, v_pool, k_new_g, v_new_g, table,
                        block_size: int, pos, scale: float):
    """Exact softmax partials of rows q_g (B, Hkv, R, d) over keys 0..pos
    (``decode.py:156``): K5 streams the pools (keys 0..pos-1; the key
    pools' widths sum to d), the current token (k_new_g (B, Hkv, d),
    v_new_g (B, Hkv, dv)) is merged on top."""
    m, l, acc = paged_row_stats_lanes(
        q_g.contiguous(), k_pools, v_pool, table, pos, scale=scale,
        block_size=block_size)
    s_new = torch.einsum("bhrd,bhd->bhr", q_g.float(),
                         k_new_g.float())[..., None] * scale
    return flash_merge(m, l, acc, s_new, torch.ones_like(s_new),
                       v_new_g[:, :, None, :].float())


def _paged_active_stats_fn(k_pools, v_pool, k_new_g, v_new_g, table,
                           block_size: int, pos, scale: float):
    """``active_stats_fn`` hook (``decode.py:179``): the active landmark
    row of each query head, grouped onto its kv head, recomputed through
    K5 in one launch for all lanes."""
    hkv = v_pool.shape[0]

    def fn(q_act):  # (B, H, 1, d)
        b, h = q_act.shape[:2]
        q_g = q_act.reshape(b, hkv, h // hkv, q_act.shape[-1])
        m, l, acc = _paged_merged_stats(q_g, k_pools, v_pool, k_new_g,
                                        v_new_g, table, block_size, pos, scale)
        return (m.reshape(b, h, 1, 1), l.reshape(b, h, 1, 1),
                acc.reshape(b, h, 1, acc.shape[-1]))

    return fn


def full_decode_attention_paged(q, k_pools, v_pool, k_new_g, v_new_g, table,
                                block_size: int, pos, scale: float):
    """Exact decode attention (one query row per head) from the block pools
    (``decode.py:202``): K5 with r = H / Hkv rows per kv head.
    q (B, H, 1, d) -> (B, H, 1, dv)."""
    b, h = q.shape[:2]
    hkv = v_pool.shape[0]
    q_g = q.float().reshape(b, hkv, h // hkv, q.shape[-1])
    m, l, acc = _paged_merged_stats(q_g, k_pools, v_pool, k_new_g, v_new_g,
                                    table, block_size, pos, scale)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, 1, out.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------
# per-layer decode
# --------------------------------------------------------------------------
def gqa_decode(p, cfg: ModelConfig, x, cache, pos, *, seq_max: int,
               table=None, block_size: int = 0):
    """One layer's GQA decode (``decode.py:228``). x (B, 1, D); ``cache``
    this layer's leaves: ``k``/``v`` pools (Hkv, nb, bs, Dh) when ``table``
    (B, n_slots) is given (the paged route), else views (B, Hkv, S, Dh)
    (the gather route); lane leaves (B, ...). Returns (attn_out (B, 1, D),
    new layer leaves) with ``k``/``v`` the new token (B, Hkv, 1, Dh)."""
    dh = cfg.resolved_head_dim
    q, k, v = gqa_project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        sin, cos = rotary_angles(pos[:, None], dh, cfg.rope_theta)  # (B, 1, dh/2)
        q = apply_rotary(q, sin[:, None], cos[:, None])
        k = apply_rotary(k, sin[:, None], cos[:, None])

    new = {"k": k, "v": v}
    new["q_lmk"] = lmk_add(cache["q_lmk"], q[:, :, 0], pos, seq_max)
    new["k_lmk"] = lmk_add(cache["k_lmk"], k[:, :, 0], pos, seq_max)
    new.update((name, cache[name]) for name in STREAM_LEAVES)
    scale = dh**-0.5
    paged = table is not None
    # a frozen tick reads nothing of the horizon: no K5, no view
    frozen = (cfg.decode_attention_impl == "spectral_shift"
              and cfg.decode_streaming == "frozen")
    if paged:
        k_pools, v_pool = (cache["k"],), cache["v"]
        k_new_g, v_new_g = k[:, :, 0], v[:, :, 0]           # raw kv heads
    elif not frozen:
        k_view = _update_seq(cache["k"], k, pos)
        v_view = _update_seq(cache["v"], v, pos)
    if cfg.decode_attention_impl == "spectral_shift":
        k_lmk = _broadcast_kv(new["k_lmk"], cfg.num_heads)
        if cfg.decode_streaming == "recompute":
            if paged:
                raise ValueError("decode_streaming='recompute' rebuilds the dense "
                                 "B matrix and is only served by the gather route")
            out = ss_decode_attention(
                q, _broadcast_kv(k_view, cfg.num_heads),
                _broadcast_kv(v_view, cfg.num_heads), new["q_lmk"], k_lmk, pos,
                cfg, scale, seq_max)
        else:
            k_new = _broadcast_kv(k, cfg.num_heads)[:, :, 0]    # (B, H, d)
            v_new = _broadcast_kv(v, cfg.num_heads)[:, :, 0]
            stats = tuple(cache[name] for name in STREAM_LEAVES)
            if frozen:
                stats_fn = None
            elif paged:
                stats_fn = _paged_active_stats_fn(k_pools, v_pool, k_new_g, v_new_g,
                                                  table, block_size, pos, scale)
            else:
                stats_fn = _view_active_stats_fn(k_view, v_view, pos, scale)
            out, new_stats = ss_decode_attention_streaming(
                q, k_new, v_new, new["q_lmk"], k_lmk, stats, pos, cfg, scale,
                seq_max, stats_fn)
            new.update(zip(STREAM_LEAVES, new_stats))
    elif paged:
        out = full_decode_attention_paged(q, k_pools, v_pool, k_new_g, v_new_g,
                                          table, block_size, pos, scale)
    else:
        out = full_decode_attention(q, _broadcast_kv(k_view, cfg.num_heads),
                                    _broadcast_kv(v_view, cfg.num_heads), pos, scale)
    return output_projection(out, p["w_o"]), new


def mla_decode(p, cfg: ModelConfig, x, cache, pos, *, seq_max: int,
               table=None, block_size: int = 0):
    """One layer's absorbed MLA decode (``decode.py:314``): attention in the
    (kv_lora + rope) latent space, the latents as values, up-projected
    after mixing. ``cache`` this layer's leaves: ``latent``/``rope`` pools
    (1, nb, bs, r|dr) when ``table`` is given (the paged route: K5 reads
    them as two key pools, the latent pool also the value pool), else views
    (B, 1, S, r|dr) (the gather route); lane leaves (B, ...). Returns
    (attn_out (B, 1, D), new layer leaves) with ``latent``/``rope`` the new
    token (B, 1, 1, r|dr)."""
    dr = cfg.rope_head_dim
    sin, cos = rotary_angles(pos[:, None], dr, cfg.rope_theta)   # (B, 1, dr/2)
    sin, cos = sin[:, None], cos[:, None]
    c_kv, k_rope = mla_project_kv(p, cfg, x, sin, cos)           # (B, 1, r|dr)
    q_eff = mla_project_q(p, cfg, x, sin, cos)                   # (B, H, 1, de)
    k_eff_new = torch.cat([c_kv, k_rope], dim=-1)                # (B, 1, de)

    new = {"latent": c_kv[:, None], "rope": k_rope[:, None]}
    new["k_lmk"] = lmk_add(cache["k_lmk"], k_eff_new, pos, seq_max)
    new["q_lmk"] = lmk_add(cache["q_lmk"], q_eff[:, :, 0], pos, seq_max)
    new.update((name, cache[name]) for name in STREAM_LEAVES)
    scale = mla_scale(cfg)
    h = cfg.num_heads
    paged = table is not None
    frozen = (cfg.decode_attention_impl == "spectral_shift"
              and cfg.decode_streaming == "frozen")
    if paged:
        k_pools, v_pool = (cache["latent"], cache["rope"]), cache["latent"]
    elif not frozen:
        lat_view = _update_seq(cache["latent"], new["latent"], pos)
        k_view = torch.cat([lat_view, _update_seq(cache["rope"], new["rope"], pos)],
                           dim=-1)                               # (B, 1, S, de)
    if cfg.decode_attention_impl == "spectral_shift":
        k_lmk = _broadcast_kv(new["k_lmk"], h)
        if cfg.decode_streaming == "recompute":
            if paged:
                raise ValueError("decode_streaming='recompute' rebuilds the dense "
                                 "B matrix and is only served by the gather route")
            out_lat = ss_decode_attention(
                q_eff, _broadcast_kv(k_view, h), _broadcast_kv(lat_view, h),
                new["q_lmk"], k_lmk, pos, cfg, scale, seq_max)
        else:
            k_new = k_eff_new.expand(-1, h, -1)                  # (B, H, de)
            v_new = c_kv.expand(-1, h, -1)                       # (B, H, r)
            stats = tuple(cache[name] for name in STREAM_LEAVES)
            if frozen:
                stats_fn = None
            elif paged:
                stats_fn = _paged_active_stats_fn(k_pools, v_pool, k_eff_new, c_kv,
                                                  table, block_size, pos, scale)
            else:
                stats_fn = _view_active_stats_fn(k_view, lat_view, pos, scale)
            out_lat, new_stats = ss_decode_attention_streaming(
                q_eff, k_new, v_new, new["q_lmk"], k_lmk, stats, pos, cfg, scale,
                seq_max, stats_fn)
            new.update(zip(STREAM_LEAVES, new_stats))
    elif paged:
        out_lat = full_decode_attention_paged(q_eff, k_pools, v_pool, k_eff_new, c_kv,
                                              table, block_size, pos, scale)
    else:
        out_lat = full_decode_attention(q_eff, _broadcast_kv(k_view, h),
                                        _broadcast_kv(lat_view, h), pos, scale)
    return mla_output(p, out_lat, x.dtype), new


def _dense_layer_decode(lp, cfg: ModelConfig, x, lcache, pos, **route):
    """``decode.py:496``: attention (GQA or MLA), then the MLP or MoE."""
    h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    attn_fn = mla_decode if cfg.mla else gqa_decode
    attn, new_cache = attn_fn(lp["attn"], cfg, h, lcache, pos, **route)
    x = x + attn
    h = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
    if cfg.moe:
        ff, _ = moe_forward(lp["moe"], cfg, h)
    else:
        ff = mlp_forward(lp["mlp"], h, cfg.act)
    return x + ff, new_cache


def mamba_decode(p, cfg: ModelConfig, x, state):
    """One step of the selective SSM (``decode.py:418``). x (B, 1, D);
    ``state`` {``ssm_h`` (B, di, N) fp32, ``conv`` (B, W - 1, di)}.
    Returns (out (B, 1, D), new state)."""
    dt = x.dtype
    ui = x[:, 0] @ p["w_in"].to(dt)                              # (B, 2di)
    di = ui.shape[-1] // 2
    u, z = ui[..., :di], ui[..., di:]
    ctx = torch.cat([state["conv"].to(dt), u[:, None]], dim=1)   # (B, W, di)
    u_conv = torch.einsum("bwd,wd->bd", ctx, p["conv_w"].to(dt)) + p["conv_b"].to(dt)
    u_conv = F.silu(u_conv)
    n = cfg.ssm_state
    bc = u_conv @ p["w_bc"].to(dt)
    b_mat, c_mat = bc[..., :n], bc[..., n:]
    dt_pre = (u_conv @ p["w_dt"].to(dt)) @ p["w_dt_out"].to(dt)
    delta = F.softplus(dt_pre.float() + p["b_dt"].float())
    a = -torch.exp(p["a_log"].float())
    abar = torch.exp(delta[..., None] * a)                       # (B, di, N)
    bbar = delta[..., None] * b_mat.float()[:, None, :] * u_conv.float()[..., None]
    h_new = abar * state["ssm_h"] + bbar
    y = torch.einsum("bdn,bn->bd", h_new, c_mat.float())
    y = y + p["d_skip"].float() * u_conv.float()
    out = (y.to(dt) * F.silu(z)) @ p["w_out"].to(dt)
    return out[:, None], {"ssm_h": h_new, "conv": ctx[:, 1:]}


def _hymba_layer_decode(lp, cfg: ModelConfig, x, lcache, pos, **route):
    """``decode.py:511``: GQA decode and the mamba step on the same normed
    input, mixed by the per-channel gates, then the MLP. ``lcache`` holds
    both groups' leaves by name; so does the returned dict."""
    h = rms_norm(x, lp["norm_mix"], cfg.norm_eps)
    attn_cache = {k: v for k, v in lcache.items() if k not in MAMBA_LEAVES}
    attn, new_cache = gqa_decode(lp["attn"], cfg, h, attn_cache, pos, **route)
    ssm, ssm_state = mamba_decode(lp["mamba"], cfg, h,
                                  {k: lcache[k] for k in MAMBA_LEAVES})
    x = x + (lp["gate_attn"].to(x.dtype) * attn + lp["gate_ssm"].to(x.dtype) * ssm)
    h = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
    x = x + mlp_forward(lp["mlp"], h, cfg.act)
    new_cache.update(ssm_state)
    return x, new_cache


def mlstm_block_decode(p, cfg: ModelConfig, x, state):
    """One token through an mLSTM block (``decode.py:443``). x (B, 1, D);
    ``state`` {``c``, ``n``, ``m``, ``conv``}. Returns (x + out, new
    state)."""
    b = x.shape[0]
    h = cfg.num_heads
    dt = x.dtype
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    up = xn[:, 0] @ p["w_up"].to(dt)                             # (B, 2di)
    di = up.shape[-1] // 2
    xm, z = up[..., :di], up[..., di:]
    ctx = torch.cat([state["conv"].to(dt), xm[:, None]], dim=1)  # (B, W, di)
    xc = F.silu(torch.einsum("bwd,wd->bd", ctx, p["conv_w"].to(dt)) + p["conv_b"].to(dt))
    q = (xc @ p["w_q"].to(dt)).reshape(b, h, di // h)
    k = (xc @ p["w_k"].to(dt)).reshape(b, h, di // h)
    v = (xm @ p["w_v"].to(dt)).reshape(b, h, di // h)
    gates = xc @ p["w_if"].to(dt) + p["b_if"].to(dt)
    core, (c_n, n_n, m_n) = mlstm_step(q, k, v, gates[..., :h],
                                       F.logsigmoid(gates[..., h:].float()),
                                       (state["c"], state["n"], state["m"]))
    core = rms_norm(core.reshape(b, di), p["ln_inner"], cfg.norm_eps)
    # the cell's output is fp32: as in the reference, the product and the
    # residual promote to fp32 (the stack runs fp32 from here on)
    gated = core * F.silu(z)
    out = gated @ p["w_down"].to(dt).to(gated.dtype)
    return x + out[:, None], {"c": c_n, "n": n_n, "m": m_n, "conv": ctx[:, 1:]}


def slstm_block_decode(p, cfg: ModelConfig, x, state):
    """One token through an sLSTM block (``decode.py:468``). x (B, 1, D);
    ``state`` {``c``, ``n``, ``m``, ``h``}. Returns (x + out, new state)."""
    b = x.shape[0]
    dt = x.dtype
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    xg = torch.einsum("bd,dhge->bhge", xn[:, 0], p["w_g"].to(dt)) + p["b_g"].to(dt)
    rec = torch.einsum("bhd,hgde->bhge", state["h"], p["r_w"].float())
    c_new, n_new, m_new, h_new = slstm_cell(xg.float() + rec, state["c"], state["n"],
                                            state["m"])
    hs = rms_norm(h_new.reshape(b, cfg.d_model).to(dt), p["ln_inner"], cfg.norm_eps)
    out = gelu(hs @ p["w_out"].to(dt)) @ p["w_down"].to(dt)
    return x + out[:, None], {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def _xlstm_layer_decode(lp, cfg: ModelConfig, x, lcache, pos, **route):
    """One xLSTM block (``decode_step``'s ``ssm`` branch, ``decode.py:549``).
    ``lcache`` is keyed by storage keys (``kind_mlstm/c`` and the like);
    so is the returned state."""
    keys = {k.rsplit("/", 1)[-1]: k for k in lcache}
    state = {name: lcache[k] for name, k in keys.items()}
    if "kind_slstm" in lp:
        x, new = slstm_block_decode(lp["kind_slstm"], cfg, x, state)
    else:
        x, new = mlstm_block_decode(lp["kind_mlstm"], cfg, x, state)
    return x, {keys[name]: t for name, t in new.items()}


def _whisper_layer_decode(lp, cfg: ModelConfig, x, lcache, pos, **route):
    """One Whisper decoder layer (``_whisper_decode``, ``decode.py:598``):
    ``gqa_decode`` self-attention, cross attention as an fp32 softmax
    over the layer's ``cross_k`` / ``cross_v`` (B, H, 1500, Dh), the gelu
    MLP. The cross leaves are read, never returned."""
    def ln(t, name):
        return layer_norm(t, lp[name]["scale"], lp[name]["bias"], cfg.norm_eps)

    dt = x.dtype
    attn, new_cache = gqa_decode(lp["self_attn"], cfg, ln(x, "ln_self"), lcache, pos,
                                 **route)
    x = x + attn
    cp = lp["cross_attn"]
    q = project_heads(ln(x, "ln_cross"), cp["w_q"])             # (B, H, 1, Dh)
    scores = (q.float() @ lcache["cross_k"].float().transpose(-1, -2)
              * cfg.resolved_head_dim**-0.5)
    cr = (torch.softmax(scores, dim=-1) @ lcache["cross_v"].float()).to(dt)
    x = x + output_projection(cr, cp["w_o"])
    x = x + mlp_forward(lp["mlp"], ln(x, "ln_mlp"), "gelu")
    return x, new_cache


LAYER_DECODE = {"dense": _dense_layer_decode, "moe": _dense_layer_decode,
                "vlm": _dense_layer_decode, "hybrid": _hymba_layer_decode,
                "ssm": _xlstm_layer_decode, "audio": _whisper_layer_decode}


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor, *,
                seq_max: int, paged_table: torch.Tensor = None,
                block_size: int = 0):
    """One decode step for all lanes (``decode.py:526``). tokens (B, 1);
    ``paged_table`` (B, n_slots) int32 with ``block_size`` selects the
    paged route, else the sequence leaves are dense views (the gather
    route). Returns ``(logits (B, 1, V), {"pos": pos + 1, "layers":
    [per-layer leaves]})`` where each layer's ``k``/``v`` is the new token
    to commit."""
    if cfg.family not in LAYER_DECODE:
        raise NotImplementedError(f"unknown family {cfg.family!r}")
    layer_decode = LAYER_DECODE[cfg.family]
    params = working_params(params, cfg)
    pos = cache["pos"]
    layers = cache["layers"]
    dt = torch_dtype(cfg.compute_dtype)
    x = _embed_tokens(params, cfg, tokens).to(dt)
    if cfg.family == "audio":
        dec_pos = params["dec_pos"]
        x = x + dec_pos[torch.clamp(pos.long(), max=dec_pos.shape[0] - 1)][:, None].to(dt)
    new_layers = []
    for i in range(cfg.num_layers):
        x, nc = layer_decode(
            layer_params(params, i), cfg, x, layer_leaves(cfg, layers, i), pos,
            seq_max=seq_max, table=paged_table, block_size=block_size)
        new_layers.append(nc)
    if cfg.family == "audio":
        x = layer_norm(x, params["dec_ln"]["scale"], params["dec_ln"]["bias"], cfg.norm_eps)
    else:
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), {"pos": pos + 1, "layers": new_layers}
