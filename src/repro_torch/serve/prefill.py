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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import full_attention
from repro_torch.kernels.ops import ss_attention_fused
from repro_torch.kernels.ss_attention import landmark_summary
from repro_torch.models.attention import (_broadcast_kv, gqa_project_qkv,
                                          output_projection, ss_config_from)
from repro_torch.models.layers import apply_rotary, mlp_forward, rms_norm, rotary_angles
from repro_torch.models.model import (_embed_tokens, _unembed, layer_params,
                                      torch_dtype, working_params)
from repro_torch.serve.decode import full_decode_attention, ss_decode_attention
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


def _fused(cfg: ModelConfig, prefill_impl: str) -> bool:
    """Whether the prompt's attention runs the ss_fused branch (else the
    replay branch: ``prefill.py:146``)."""
    return prefill_impl == "ss_fused" and cfg.decode_attention_impl == "spectral_shift"


def _attend_prefill(cfg: ModelConfig, prefill_impl: str, q, kb, vb, scale: float,
                    n_valid: int, seq_max: int, q_sums=None, k_sums_b=None):
    """Prompt attention (``prefill.py:123``). q (B, H, n, d); kb/vb
    kv-broadcast, pad-masked keys/values; q_sums/k_sums_b the per-position
    landmark prefixes (n, B, H, c, d) that the replay branch of spectral
    shift reads. Returns (B, H, n, dv)."""
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
    pos = torch.arange(n, device=q.device)[:, None].expand(n, q.shape[0])
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
        n, b, hkv = k_sums.shape[:3]
        k_sums_b = _broadcast_kv(k_sums.reshape(n * b, hkv, *k_sums.shape[3:]),
                                 cfg.num_heads).reshape(n, b, cfg.num_heads,
                                                        *k_sums.shape[3:])
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


def _dense_layer_prefill(lp, cfg: ModelConfig, x, sin, cos, t_mask, oh,
                         seq_max: int, n_valid: int, prefill_impl: str):
    h = rms_norm(x, lp["norm_attn"], cfg.norm_eps)
    attn, new_cache = _gqa_prefill(lp["attn"], cfg, h, sin, cos, t_mask, oh,
                                   seq_max, n_valid, prefill_impl)
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
    sin, cos = rotary_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
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
