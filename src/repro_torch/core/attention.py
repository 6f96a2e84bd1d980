"""Attention implementations (``repro/core/attention.py``): exact softmax
attention, its key-blockwise online-softmax form, Nystrom, and the
paper's spectral shifting.

All functions take ``q`` (..., n_q, d), ``k``/``v`` (..., n_k, d) with
shared leading dims and return (..., n_q, d_v). Softmax runs in fp32;
outputs are cast back to the input dtype. ``spectral_shift_attention``
with ``use_shift=False`` reduces exactly to Nystromformer attention.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.landmarks import segment_means, segment_of
from repro_torch.core.spectral_shift import ss_core

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SSConfig:
    """Hyper-parameters of the spectral-shifting approximation."""

    num_landmarks: int = 64
    pinv_iters: int = 6
    method: str = "iterative"
    rank_tol: float = 1e-3
    use_shift: bool = True               # False => exact Nystromformer
    include_shift_identity: bool = True  # the + delta_ss * V output term
    variant: str = "closed_form"         # "closed_form" | "eq10_literal"
    causal: bool = False                 # segment-causal masking
    landmark_via_matmul: bool = False
    delta_scale: str = "paper"           # "paper" | "corrected" (x c/n)


def _softmax(scores: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 softmax over the last axis; masked entries get exactly 0 and a
    fully masked row gives zeros (``attention.py:48``)."""
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    out = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    if mask is not None:
        out = torch.where(mask, out, 0.0)
    return out / torch.clamp(out.sum(dim=-1, keepdim=True), min=1e-30)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact O(n^2) softmax attention (``attention.py:58``); causal queries
    are the last n_q positions of the n_k-long context."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    scores = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal:
        n_q, n_k = q.shape[-2], k.shape[-2]
        cmask = (torch.arange(n_k, device=q.device)[None, :]
                 <= (torch.arange(n_q, device=q.device)[:, None] + (n_k - n_q)))
        mask = cmask if mask is None else mask & cmask
    attn = _softmax(scores, mask)
    return torch.einsum("...qk,...kd->...qd", attn, v.float()).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = False, block: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Exact softmax attention computed blockwise over keys with the online
    softmax recurrence (``attention.py:85``): the O(n^2) score matrix is
    never held whole. Keys are padded to a whole number of ``block``-key
    blocks and masked past n_k; causal queries are the last n_q positions
    of the n_k-long context."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    n_q, n_k = q.shape[-2], k.shape[-2]
    block = min(block, n_k)
    pad = -n_k % block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    nb = (n_k + pad) // block
    q32 = q.float()
    dev = q.device
    qpos = torch.arange(n_q, device=dev) + (n_k - n_q)
    lead = q.shape[:-2]
    m = torch.full((*lead, n_q), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((*lead, n_q), dtype=torch.float32, device=dev)
    acc = torch.zeros((*lead, n_q, v.shape[-1]), dtype=torch.float32, device=dev)
    for i in range(nb):
        kblk = k[..., i * block:(i + 1) * block, :]
        vblk = v[..., i * block:(i + 1) * block, :]
        s = torch.einsum("...qd,...kd->...qk", q32, kblk.float()) * scale
        kpos = i * block + torch.arange(block, device=dev)
        mask = (kpos < n_k)[None, :]
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("...qk,...kd->...qd", p,
                                                   vblk.float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _ss_factors(q, k, cfg: SSConfig, scale: float, q_landmarks=None,
                k_landmarks=None):
    """The three softmax factor matrices F (n_q, c), A (c, c), B (c, n_k)
    (``attention.py:144``), segment-causally masked under ``cfg.causal``."""
    m = cfg.num_landmarks
    mm = cfg.landmark_via_matmul
    q_l = segment_means(q, m, via_matmul=mm) if q_landmarks is None else q_landmarks
    k_l = segment_means(k, m, via_matmul=mm) if k_landmarks is None else k_landmarks
    if q_l.shape[-2] != k_l.shape[-2]:
        raise ValueError(
            "spectral-shift attention needs matching landmark counts for Q~ "
            f"and K~, got {q_l.shape[-2]} vs {k_l.shape[-2]}. For decode "
            "(n_q=1) pass cached q_landmarks/k_landmarks explicitly.")
    f_mask = a_mask = b_mask = None
    if cfg.causal:
        n_q, n_k = q.shape[-2], k.shape[-2]
        c = k_l.shape[-2]
        dev = q.device
        qpos = torch.arange(n_q, device=dev) + (n_k - n_q)
        rows = torch.arange(c, device=dev)
        # query i sees the landmark segments up to its own
        f_mask = rows[None, :] <= segment_of(qpos, n_k, m)[:, None]
        a_mask = rows[:, None] >= rows[None, :]
        seg = -(-n_k // m)
        b_mask = torch.arange(n_k, device=dev)[None, :] < (rows[:, None] + 1) * seg
    f = _softmax(torch.einsum("...qd,...cd->...qc", q, k_l) * scale, f_mask)
    a = _softmax(torch.einsum("...cd,...ed->...ce", q_l, k_l) * scale, a_mask)
    b = _softmax(torch.einsum("...cd,...kd->...ck", q_l, k) * scale, b_mask)
    return f, a, b


def spectral_shift_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             cfg: SSConfig = SSConfig(), *,
                             scale: Optional[float] = None,
                             q_landmarks: Optional[torch.Tensor] = None,
                             k_landmarks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear-time attention via Modified Spectral Shifting (paper eq. (10),
    ``attention.py:173``):

        out = F @ U_ss @ (B @ V) [+ delta_ss * V],  U_ss = Z*(I - delta Z*).

    n_q and n_k <= c (without explicit landmarks) is exact attention.
    ``q_landmarks`` / ``k_landmarks`` override the segment means."""
    if (q.shape[-2] <= cfg.num_landmarks and k.shape[-2] <= cfg.num_landmarks
            and q_landmarks is None):
        return full_attention(q, k, v, causal=cfg.causal, scale=scale)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    f, a, b = _ss_factors(q, k, cfg, scale, q_landmarks, k_landmarks)
    core = ss_core(a, method=cfg.method, pinv_iters=cfg.pinv_iters,
                   rank_tol=cfg.rank_tol, use_shift=cfg.use_shift)
    c = a.shape[-1]
    eye = torch.eye(c, dtype=core.z.dtype, device=a.device)
    if cfg.delta_scale == "corrected" and cfg.use_shift:
        # the core-fitted shift rescaled to the n x n softmax scale (c / n)
        delta = core.delta * (c / k.shape[-2])
        core = core._replace(delta=delta, u=core.z @ (eye - delta * core.z))
    if cfg.variant == "eq10_literal":
        u = core.z @ (eye - core.delta * a)
    else:
        u = core.u
    if cfg.causal:
        # the exact pinv of the lower-triangular core is lower-triangular:
        # project the finite Newton-Schulz estimate back (no future leak)
        u = torch.where(torch.tril(torch.ones((c, c), dtype=torch.bool,
                                              device=a.device)), u, 0.0)
    v32 = v.float()
    bv = torch.einsum("...ck,...kd->...cd", b, v32)
    out = torch.einsum("...qc,...cd->...qd", f, u.float() @ bv)
    n_q, n_k = q.shape[-2], k.shape[-2]
    if cfg.include_shift_identity and n_q <= n_k:
        # + delta_ss I_n -> + delta_ss * V on the trailing (query-aligned) rows
        out = out + core.delta.float() * v32[..., n_k - n_q:, :]
    return out.to(q.dtype)


def nystrom_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_landmarks: int = 64, pinv_iters: int = 6,
                      causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Nystromformer baseline (paper §2.4, ``attention.py:250``):
    F @ A^+ @ (B @ V)."""
    cfg = SSConfig(num_landmarks=num_landmarks, pinv_iters=pinv_iters,
                   method="iterative", use_shift=False,
                   include_shift_identity=False, causal=causal)
    return spectral_shift_attention(q, k, v, cfg, scale=scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              impl: str = "full", *, causal: bool = False,
              ss_cfg: Optional[SSConfig] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch between attention implementations by name
    (``attention.py:272``)."""
    if impl == "full":
        return full_attention(q, k, v, causal=causal, scale=scale)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, scale=scale)
    if impl == "nystrom":
        cfg = ss_cfg or SSConfig()
        return nystrom_attention(q, k, v, num_landmarks=cfg.num_landmarks,
                                 pinv_iters=cfg.pinv_iters, causal=causal,
                                 scale=scale)
    if impl == "spectral_shift":
        cfg = ss_cfg or SSConfig()
        if causal and not cfg.causal:
            cfg = dataclasses.replace(cfg, causal=True)
        return spectral_shift_attention(q, k, v, cfg, scale=scale)
    raise ValueError(f"unknown attention impl: {impl!r}")
