"""Whole-prompt prefill through the spectral-shift kernels
(``repro/serve/prefill.py``, ``prefill_impl="ss_fused"``).

One forward pass over the (bucket-padded) prompt computes per layer

* K/V for every prompt position (padded positions zeroed);
* the landmark running sums ``q_lmk``/``k_lmk`` over the first ``n_valid``
  tokens with the cache's ``seq_max`` segment routing;
* the prompt's attention outputs: exact masked attention for windows of at
  most c tokens, else ``ss_attention_fused`` (kernels K1 + K2) with
  ``kv_valid = n_valid`` so the pad never enters a softmax or a mean;
* the streaming decode state (m, l, acc), handed over from a second K1
  pass with the cache's landmark means and ``return_stats``.

The per-position landmark prefixes of the reference's token-replay route
are not needed by ``ss_fused`` and are not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import full_attention
from repro_torch.kernels.ops import ss_attention_fused
from repro_torch.kernels.ss_attention import landmark_summary
from repro_torch.models.attention import _broadcast_kv, gqa_project_qkv, ss_config_from
from repro_torch.models.layers import apply_rotary, mlp_forward, rms_norm, rotary_angles
from repro_torch.models.model import (_embed_tokens, _unembed, layer_params,
                                      torch_dtype, working_params)
from repro_torch.serve.decode_state import (landmark_counts, landmark_means,
                                            mask_stats_rows, recompute_stats,
                                            segment_len)


def _routing(n: int, n_valid: int, seq_max: int, c: int, device):
    """(t_mask (n,), onehot (n, c)) segment routing of a prompt window, with
    positions >= n_valid zeroed (``prefill.py:102``)."""
    t = torch.arange(n, device=device)
    t_mask = t < n_valid
    oh = F.one_hot(t // segment_len(seq_max, c), c).float() * t_mask[:, None]
    return t_mask, oh


def _landmark_sums(oh: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Landmark running sums after the whole window: oh (n, c) masked
    routing, x (B, H, n, d) -> fp32 (B, H, c, d). The last entry of the
    reference's per-position ``_prefix_sums`` (``prefill.py:112``)."""
    return torch.einsum("nc,bhnd->bhcd", oh, x.float())


def _attend_prefill(cfg: ModelConfig, q, kb, vb, scale: float, n_valid: int):
    """Prompt attention (``prefill.py:123``, the ``ss_fused`` branch).
    q (B, H, n, d); kb/vb kv-broadcast, pad-masked keys/values."""
    n = q.shape[2]
    if n <= cfg.num_landmarks:
        # Degenerate window: exact attention with the key-validity mask.
        key_mask = (torch.arange(n, device=q.device) < n_valid)[None, None, None, :]
        return full_attention(q, kb, vb, mask=key_mask, scale=scale)
    return ss_attention_fused(q, kb, vb, ss_config_from(cfg, causal=False),
                              scale=scale, kv_valid=n_valid)


def _seed_stream_stats(cfg: ModelConfig, q_l, kb, vb, n_valid: int,
                       scale: float, seq_max: int):
    """Streaming decode state for one layer, seeded from the whole prompt
    (``prefill.py:174``): per-landmark partials (m, l, acc) over keys
    0..n_valid-1 keyed by the cache's landmark means q_l (B, H, c, d). A
    window longer than c runs K1 with ``return_stats`` and rebuilds
    ``acc = BV * l`` from BV in v's dtype (that rounding is part of the
    reference's behaviour); shorter windows recompute in plain torch. Rows
    past the active segment are zeroed."""
    c = cfg.num_landmarks
    pos_last = n_valid - 1
    b, h, n, d = kb.shape
    dv = vb.shape[-1]
    if n > c:
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


def _gqa_prefill(p, cfg: ModelConfig, x, sin, cos, t_mask, oh, seq_max: int,
                 n_valid: int):
    q, k, v = gqa_project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        q = apply_rotary(q, sin, cos)
        k = apply_rotary(k, sin, cos)
    pad = t_mask[None, None, :, None]
    k_m = torch.where(pad, k, 0).to(k.dtype)
    v_m = torch.where(pad, v, 0).to(v.dtype)

    q_sum = _landmark_sums(oh, q)        # (B, H, c, d)
    k_sum = _landmark_sums(oh, k_m)      # (B, Hkv, c, d)
    # The kv heads broadcast to all query heads before the kernels, as the
    # reference does (7x the kv bytes at Qwen2-7B's 28/4 heads).
    kb = _broadcast_kv(k_m, cfg.num_heads)
    vb = _broadcast_kv(v_m, cfg.num_heads)

    scale = cfg.resolved_head_dim ** -0.5
    out = _attend_prefill(cfg, q, kb, vb, scale, n_valid)
    c = cfg.num_landmarks
    counts = landmark_counts(torch.tensor([n_valid - 1], device=x.device),
                             seq_max, c)
    bv_m, bv_l, bv_acc = _seed_stream_stats(
        cfg, landmark_means(q_sum, counts), kb, vb, n_valid, scale, seq_max)
    new_cache = {"k": k_m, "v": v_m, "q_lmk": q_sum, "k_lmk": k_sum,
                 "bv_m": bv_m, "bv_l": bv_l, "bv_acc": bv_acc}
    attn = torch.einsum("bhse,hed->bsd", out.to(x.dtype), p["w_o"].to(x.dtype))
    return attn, new_cache


def _dense_layer_prefill(lp, cfg: ModelConfig, x, sin, cos, t_mask, oh,
                         seq_max: int, n_valid: int):
    h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    attn, new_cache = _gqa_prefill(lp["attn"], cfg, h, sin, cos, t_mask, oh,
                                   seq_max, n_valid)
    x = x + attn
    h = rms_norm(x, lp["norm_mlp"], cfg.norm_eps)
    return x + mlp_forward(lp["mlp"], h, cfg.act), new_cache


def batched_prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
                    n_valid: int, *, seq_max: int,
                    prefill_impl: str = "ss_fused"):
    """Run a whole (padded) prompt through the model in one pass
    (``prefill.py:335``). tokens (1, n_pad), ``n_valid`` <= n_pad real
    tokens. Returns ``(logits (1, n_pad, V), cache)`` with the reference's
    B=1 cache layout: ``cache["layers"][name]`` stacked (L, 1, ...), K/V
    zero past n_valid, ``cache["pos"] = n_valid``. The next-token logits
    are at index ``n_valid - 1``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if prefill_impl != "ss_fused" or cfg.decode_attention_impl != "spectral_shift":
        raise NotImplementedError(
            "only ss_fused prefill with spectral-shift attention is ported")
    n = tokens.shape[1]
    n_valid = int(n_valid)
    if n > cfg.num_landmarks and n_valid <= cfg.num_landmarks:
        raise ValueError(
            f"ss_fused prefill: prompt length {n_valid} <= num_landmarks "
            f"{cfg.num_landmarks} must run in a window of at most "
            f"num_landmarks tokens (the engine slices such prompts) — the "
            f"masked kernels model the > num_landmarks regime only")
    params = working_params(params, cfg)
    x = _embed_tokens(params, cfg, tokens).to(torch_dtype(cfg.compute_dtype))
    t_mask, oh = _routing(n, n_valid, seq_max, cfg.num_landmarks, x.device)
    positions = torch.arange(n, device=x.device)[None]
    sin, cos = rotary_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    sin, cos = sin[:, None], cos[:, None]                   # (1, 1, n, dh/2)

    per_layer = []
    for i in range(cfg.num_layers):
        x, nc = _dense_layer_prefill(layer_params(params, i), cfg, x, sin, cos,
                                     t_mask, oh, seq_max, n_valid)
        per_layer.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    layers = {name: torch.stack([nc[name] for nc in per_layer])
              for name in per_layer[0]}
    cache = {"pos": torch.tensor(n_valid, dtype=torch.int32, device=x.device),
             "layers": layers}
    return _unembed(params, cfg, x), cache
