"""Iterative Moore-Penrose pseudoinverse (paper §7, eq. (11)).

    Z_{j+1} = 1/4 * Z_j (13 I - A Z_j (15 I - A Z_j (7 I - A Z_j)))

from ``Z_0 = A^T / (||A||_1 ||A||_inf)``, as ``repro/core/pinv.py:19``.
"""
from __future__ import annotations

import torch


def iterative_pinv(a: torch.Tensor, num_iters: int = 6) -> torch.Tensor:
    """Approximate pseudoinverse of ``a`` (..., c, c), computed in fp32."""
    c = a.shape[-1]
    a32 = a.float()
    eye = torch.eye(c, dtype=torch.float32, device=a.device)
    abs_a = a32.abs()
    norm_1 = abs_a.sum(dim=-2).amax(dim=-1)[..., None, None]
    norm_inf = abs_a.sum(dim=-1).amax(dim=-1)[..., None, None]
    z = a32.transpose(-1, -2) / torch.clamp(norm_1 * norm_inf, min=1e-30)
    for _ in range(num_iters):
        az = a32 @ z
        inner = 7.0 * eye - az
        inner = 15.0 * eye - az @ inner
        inner = 13.0 * eye - az @ inner
        z = 0.25 * (z @ inner)
    return z.to(a.dtype)
