"""Moore-Penrose pseudoinverses (paper §7, eq. (11)).

``iterative_pinv`` is the Newton-Schulz-type iteration

    Z_{j+1} = 1/4 * Z_j (13 I - A Z_j (15 I - A Z_j (7 I - A Z_j)))

from ``Z_0 = A^T / (||A||_1 ||A||_inf)``, as ``repro/core/pinv.py:19``;
``svd_pinv`` is the exact truncated pseudoinverse of ``pinv.py:42``, the
oracle path.
"""
from __future__ import annotations

import torch


def _promoted(a: torch.Tensor) -> torch.Tensor:
    """``a`` in at least fp32 (float64 stays float64), as
    ``jnp.promote_types(a.dtype, float32)``."""
    return a if a.dtype == torch.float64 else a.float()


def iterative_pinv(a: torch.Tensor, num_iters: int = 6) -> torch.Tensor:
    """Approximate pseudoinverse of ``a`` (..., c, c), computed in at least
    fp32."""
    c = a.shape[-1]
    a32 = _promoted(a)
    eye = torch.eye(c, dtype=a32.dtype, device=a.device)
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


def svd_pinv(a: torch.Tensor, rank_tol: float = 1e-4
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact truncated pseudoinverse via SVD. Returns ``(pinv, kept_mask,
    singular_values)``: ``kept_mask`` marks singular values above
    ``rank_tol * sigma_max`` (the effective rank the spectral-shift delta
    uses)."""
    u, s, vt = torch.linalg.svd(_promoted(a), full_matrices=False)
    keep = s > rank_tol * s.amax(dim=-1, keepdim=True)
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    pinv = torch.einsum("...ji,...j,...kj->...ik", vt, s_inv, u)
    return pinv.to(a.dtype), keep, s
