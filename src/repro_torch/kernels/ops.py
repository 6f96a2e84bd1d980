"""Spectral-shifting attention backed by the kernels (forward only).

``ss_attention_fused(q, k, v, cfg)`` mirrors ``repro/kernels/ops.py:230``:

    1. landmarks            segment means (masked under ``kv_valid``)
    2. A_s, U_ss, delta     the c x c core, ``ss_core_factors``
    3. BV                   K1 ``landmark_summary``, streamed over n
    4. M = U_ss @ BV        a (c x c) @ (c x dv) product
    5. out = F @ M + d * V  K2 ``query_side``, streamed over n

plus the online-softmax partial-state algebra (``flash_rescale`` /
``flash_merge``) that decode uses to merge the current token into the
kernels' partials. The backward kernels (K3, K4) are not ported yet, so
nothing here is differentiable through the kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import SSConfig, _softmax, full_attention
from repro_torch.core.landmarks import masked_segment_means, segment_means
from repro_torch.core.spectral_shift import ss_core
from repro_torch.kernels.ss_attention import landmark_summary, query_side


# --------------------------------------------------------------------------
# Online-softmax partial-state algebra. A partial (m, l, acc) stands for
# sum_j exp(s_j - m) (l) and sum_j exp(s_j - m) v_j (acc); any finite anchor
# m gives the same acc / l.
# --------------------------------------------------------------------------
def flash_rescale(m, l, acc, m_new):
    """Re-anchor a partial state to ``m_new`` (>= m). Returns (l, acc)."""
    corr = torch.exp(m - m_new)
    return l * corr, acc * corr


def flash_merge(m_a, l_a, acc_a, m_b, l_b, acc_b):
    """Merge two partial states (``ops.py:77``); m/l carry a trailing
    singleton axis so they broadcast against acc (..., rows, dv)."""
    m = torch.maximum(m_a, m_b)
    l_ar, acc_ar = flash_rescale(m_a, l_a, acc_a, m)
    l_br, acc_br = flash_rescale(m_b, l_b, acc_b, m)
    return m, l_ar + l_br, acc_ar + acc_br


# --------------------------------------------------------------------------
# The c x c spectral-shift core.
# --------------------------------------------------------------------------
def ss_core_factors(q_l, k_l, cfg: SSConfig, scale: float, n_k):
    """fp32 (U, delta) of the c x c core (``ops.py:166``): fp32 softmax of
    the landmark scores (causally masked for ``cfg.causal``), Newton-Schulz
    pinv and shift, the ``delta_scale="corrected"`` rescale by c / n_k (the
    TRUE key length), the ``eq10_literal`` variant and the causal
    lower-triangular projection of U."""
    c = q_l.shape[-2]
    dev = q_l.device
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    a = _softmax(torch.einsum("...cd,...ed->...ce", q_l.float(), k_l.float())
                 * scale, tril if cfg.causal else None)
    core = ss_core(a, method=cfg.method, pinv_iters=cfg.pinv_iters,
                   use_shift=cfg.use_shift)
    eye = torch.eye(c, dtype=torch.float32, device=dev)
    if cfg.delta_scale == "corrected" and cfg.use_shift:
        delta = core.delta * (c / n_k)
        core = core._replace(delta=delta, u=core.z @ (eye - delta * core.z))
    if cfg.variant == "eq10_literal":
        u = core.z @ (eye - core.delta * a)
    else:
        u = core.u
    if cfg.causal:
        u = torch.where(tril, u, 0.0)
    return u, core.delta


# --------------------------------------------------------------------------
# Full fused attention.
# --------------------------------------------------------------------------
def ss_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cfg: SSConfig = SSConfig(), *,
                       scale: Optional[float] = None,
                       kv_valid: Optional[int] = None) -> torch.Tensor:
    """Kernel-backed spectral-shifting attention, shapes (..., n, d).

    ``kv_valid`` (host int): only the first ``kv_valid`` positions are
    real; landmark means and the B-side softmax mask the padded tail, so a
    bucket-padded prompt computes what the unpadded call would (outputs
    past ``kv_valid`` are garbage the caller drops). Bidirectional
    self-attention only, and only for padded n > c."""
    *lead, n, d = q.shape
    n_k = k.shape[-2]
    dv = v.shape[-1]
    c = cfg.num_landmarks
    if kv_valid is not None:
        if cfg.causal:
            raise ValueError(
                "kv_valid masking supports the bidirectional (prefill) "
                "variant only; causal bucketing needs dynamic segment masks")
        if n != n_k:
            raise ValueError("kv_valid masking requires self-attention (n == n_k)")
        if n <= c:
            raise ValueError(
                f"kv_valid masking needs padded n ({n}) > num_landmarks "
                f"({c}); run degenerate prompts unpadded instead")
    if n <= c and n_k <= c:
        # Degenerate small-n regime: exact attention, as the reference does.
        return full_attention(q, k, v, causal=cfg.causal, scale=scale)
    scale = scale if scale is not None else 1.0 / (d**0.5)
    b = 1
    for s_ in lead:
        b *= s_
    qf = q.reshape(b, n, d).contiguous()
    kf = k.reshape(b, n_k, d).contiguous()
    vf = v.reshape(b, n_k, dv).contiguous()

    if kv_valid is not None:
        kv_valid = int(kv_valid)
        q_l = masked_segment_means(qf, c, kv_valid)
        k_l = masked_segment_means(kf, c, kv_valid)
    else:
        q_l = segment_means(qf, c, via_matmul=cfg.landmark_via_matmul)
        k_l = segment_means(kf, c, via_matmul=cfg.landmark_via_matmul)
    if q_l.shape[-2] != k_l.shape[-2]:
        raise ValueError(
            "spectral-shift attention needs matching landmark counts for Q~ "
            f"and K~, got {q_l.shape[-2]} vs {k_l.shape[-2]}")

    u, delta_core = ss_core_factors(
        q_l, k_l, cfg, scale, n_k if kv_valid is None else kv_valid)
    bv = landmark_summary(q_l.contiguous(), kf, vf, scale=scale,
                          causal=cfg.causal, kv_valid=kv_valid)   # (b, c, dv)
    m_mat = (u.float() @ bv.float()).to(v.dtype)
    if cfg.include_shift_identity and n <= n_k:
        # + delta_ss I_n -> + delta_ss * V on the query-aligned rows of V.
        delta = delta_core.float()
        v_q = vf if n == n_k else vf[:, n_k - n:].contiguous()
    else:
        delta = torch.zeros((b, 1, 1), dtype=torch.float32, device=q.device)
        v_q = vf if n == n_k else torch.zeros((b, n, dv), dtype=vf.dtype,
                                              device=q.device)
    out = query_side(qf, k_l.contiguous(), m_mat.contiguous(), v_q,
                     delta.contiguous(), scale=scale, causal=cfg.causal,
                     seq_len_k=n_k)
    return out.reshape(*lead, n, dv)
