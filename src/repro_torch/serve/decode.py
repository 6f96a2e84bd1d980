"""One decode step for every lane at once, spectral-shift decode attention
over the paged KV pools (``repro/serve/decode.py``, the paged branch).

Lanes are the batch axis: ``decode_step`` takes tokens (B, 1) and
positions (B,) and launches kernel K5 once per layer for all lanes. The
sequence-shaped leaves are the shared block pools, read only through K5;
each layer returns the NEW token's K/V for the caller to commit
(``PagedKVCache.make_paged_step``) after the step, so K5 sees keys
0..pos-1 and the current token is flash-merged on top.

Cache layout consumed here: ``cache["pos"]`` (B,) int32 and
``cache["layers"]`` with pools ``k``/``v`` (L, Hkv, num_blocks, bs, Dh) and
lane-dense leaves (L, B, ...) (``serve/kv_cache.py`` for the names).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import flash_merge
from repro_torch.kernels.paged_decode import paged_row_stats_lanes
from repro_torch.models.attention import _broadcast_kv, gqa_project_qkv
from repro_torch.models.layers import apply_rotary, mlp_forward, rms_norm, rotary_angles
from repro_torch.models.model import (_embed_tokens, _unembed, layer_params,
                                      torch_dtype, working_params)
from repro_torch.serve.decode_state import (STREAM_LEAVES, lmk_add,
                                            ss_decode_attention_streaming)

DENSE_LEAVES = ("q_lmk", "k_lmk", *STREAM_LEAVES)


def _paged_merged_stats(q_g, k_pool, v_pool, k_new_g, v_new_g, table,
                        block_size: int, pos, scale: float):
    """Exact softmax partials of rows q_g (B, Hkv, R, d) over keys 0..pos
    (``decode.py:156``): K5 streams the pools (keys 0..pos-1), the current
    token (k_new_g (B, Hkv, d), v_new_g (B, Hkv, dv)) is merged on top."""
    m, l, acc = paged_row_stats_lanes(
        q_g.contiguous(), k_pool, v_pool, table, pos, scale=scale,
        block_size=block_size)
    s_new = torch.einsum("bhrd,bhd->bhr", q_g.float(),
                         k_new_g.float())[..., None] * scale
    return flash_merge(m, l, acc, s_new, torch.ones_like(s_new),
                       v_new_g[:, :, None, :].float())


def _paged_active_stats_fn(k_pool, v_pool, k_new_g, v_new_g, table,
                           block_size: int, pos, scale: float):
    """``active_stats_fn`` hook (``decode.py:179``): the active landmark
    row of each query head, grouped onto its kv head, recomputed through
    K5 in one launch for all lanes."""
    hkv = v_pool.shape[0]

    def fn(q_act):  # (B, H, 1, d)
        b, h = q_act.shape[:2]
        q_g = q_act.reshape(b, hkv, h // hkv, q_act.shape[-1])
        m, l, acc = _paged_merged_stats(q_g, k_pool, v_pool, k_new_g,
                                        v_new_g, table, block_size, pos, scale)
        return (m.reshape(b, h, 1, 1), l.reshape(b, h, 1, 1),
                acc.reshape(b, h, 1, acc.shape[-1]))

    return fn


def full_decode_attention_paged(q, k_pool, v_pool, k_new_g, v_new_g, table,
                                block_size: int, pos, scale: float):
    """Exact decode attention (one query row per head) from the block pools
    (``decode.py:202``). q (B, H, 1, d) -> (B, H, 1, dv)."""
    b, h = q.shape[:2]
    hkv = v_pool.shape[0]
    q_g = q.float().reshape(b, hkv, h // hkv, q.shape[-1])
    m, l, acc = _paged_merged_stats(q_g, k_pool, v_pool, k_new_g, v_new_g,
                                    table, block_size, pos, scale)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, 1, out.shape[-1]).to(q.dtype)


def gqa_decode(p, cfg: ModelConfig, x, cache, pos, *, seq_max: int, table,
               block_size: int):
    """One layer's GQA decode on the paged route (``decode.py:228``).
    x (B, 1, D); ``cache`` this layer's pools (Hkv, nb, bs, Dh) and lane
    leaves (B, ...). Returns (attn_out (B, 1, D), new layer leaves) with
    ``k``/``v`` the new token (B, Hkv, 1, Dh) for the commit."""
    dt = x.dtype
    dh = cfg.resolved_head_dim
    q, k, v = gqa_project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        sin, cos = rotary_angles(pos[:, None], dh, cfg.rope_theta)  # (B, 1, dh/2)
        q = apply_rotary(q, sin[:, None], cos[:, None])
        k = apply_rotary(k, sin[:, None], cos[:, None])

    new = {"k": k, "v": v}
    new["q_lmk"] = lmk_add(cache["q_lmk"], q[:, :, 0], pos, seq_max)
    new["k_lmk"] = lmk_add(cache["k_lmk"], k[:, :, 0], pos, seq_max)
    scale = dh**-0.5
    k_pool, v_pool = cache["k"], cache["v"]
    k_new_g, v_new_g = k[:, :, 0], v[:, :, 0]               # raw kv heads
    if cfg.decode_attention_impl == "spectral_shift":
        k_lmk = _broadcast_kv(new["k_lmk"], cfg.num_heads)
        k_new = _broadcast_kv(k, cfg.num_heads)[:, :, 0]    # (B, H, d)
        v_new = _broadcast_kv(v, cfg.num_heads)[:, :, 0]
        stats = tuple(cache[name] for name in STREAM_LEAVES)
        stats_fn = _paged_active_stats_fn(k_pool, v_pool, k_new_g, v_new_g,
                                          table, block_size, pos, scale)
        out, new_stats = ss_decode_attention_streaming(
            q, k_new, v_new, new["q_lmk"], k_lmk, stats, pos, cfg, scale,
            seq_max, stats_fn)
        new.update(zip(STREAM_LEAVES, new_stats))
    else:
        out = full_decode_attention_paged(q, k_pool, v_pool, k_new_g,
                                          v_new_g, table, block_size, pos,
                                          scale)
        new.update((name, cache[name]) for name in STREAM_LEAVES)
    return torch.einsum("bhse,hed->bsd", out, p["w_o"].to(dt)), new


def _dense_layer_decode(lp, cfg: ModelConfig, x, lcache, pos, **paged):
    h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    attn, new_cache = gqa_decode(lp["attn"], cfg, h, lcache, pos, **paged)
    x = x + attn
    h = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
    return x + mlp_forward(lp["mlp"], h, cfg.act), new_cache


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor, *,
                seq_max: int, paged_table: torch.Tensor, block_size: int):
    """One decode step for all lanes (``decode.py:526``, paged route).
    tokens (B, 1); ``paged_table`` (B, n_slots) int32. Returns
    ``(logits (B, 1, V), {"pos": pos + 1, "layers": [per-layer leaves]})``
    where each layer's ``k``/``v`` is the new token to commit."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    params = working_params(params, cfg)
    pos = cache["pos"]
    layers = cache["layers"]
    x = _embed_tokens(params, cfg, tokens).to(torch_dtype(cfg.compute_dtype))
    new_layers = []
    for i in range(cfg.num_layers):
        lcache = {name: t[i] for name, t in layers.items()}
        x, nc = _dense_layer_decode(
            layer_params(params, i), cfg, x, lcache, pos, seq_max=seq_max,
            table=paged_table, block_size=block_size)
        new_layers.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), {"pos": pos + 1, "layers": new_layers}
