"""Unmasked oracles of the spectral-shifting kernels, mirroring
``repro/kernels/ref.py``: same shapes, fp32 accumulation, same output
dtype. The masked plain versions the wrappers run on CPU live beside the
kernels (``ss_attention.py``, ``paged_decode.py``)."""
from __future__ import annotations

import torch


def ref_landmark_summary(q_l, k, v, scale: float) -> torch.Tensor:
    """B-side oracle: softmax(Q~ K^T * scale) @ V -> (b, c, dv)."""
    s = torch.einsum("bcd,bnd->bcn", q_l.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bcn,bnd->bcd", p, v.float()).to(v.dtype)


def ref_query_side(q, k_l, m_mat, v, delta, scale: float) -> torch.Tensor:
    """F-side oracle: softmax(Q K~^T * scale) @ M + delta * V -> (b, n, dv)."""
    s = torch.einsum("bnd,bcd->bnc", q.float(), k_l.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnc,bcd->bnd", p, m_mat.float())
    return (out + delta.float() * v.float()).to(q.dtype)
