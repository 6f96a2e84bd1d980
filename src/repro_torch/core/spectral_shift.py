"""Modified Spectral Shifting core (paper §4), iterative path.

Given the landmark core ``A_s`` (c x c), ``repro/core/spectral_shift.py:42``
computes

    delta_ss = ( tr(A_s) - tr(A_s^+ A_s^2) ) / ( c - rank(A_s) )
    U_ss     = A_s^+ (I - delta_ss A_s^+)

with the Newton-Schulz pseudoinverse Z*, soft rank tr(A Z*) and the tail
mass as trace expressions of Z*. The SVD oracle path is not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.pinv import iterative_pinv


class SSCore(NamedTuple):
    """Spectral-shift factors: ``S ~= F @ u @ B + delta * I_n``."""

    u: torch.Tensor      # (..., c, c)  U_ss = Z (I - delta Z)
    delta: torch.Tensor  # (..., 1, 1)  spectral shift
    z: torch.Tensor      # (..., c, c)  the pseudoinverse estimate Z*


def _trace(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def ss_core(a_s: torch.Tensor, *, method: str = "iterative",
            pinv_iters: int = 6, use_shift: bool = True) -> SSCore:
    """``(U_ss, delta_ss, Z*)`` of the landmark core ``a_s`` (..., c, c).
    ``use_shift=False`` forces delta = 0 (the Nystrom prototype model)."""
    if method != "iterative":
        raise NotImplementedError(f"ss_core method {method!r} is not ported")
    c = a_s.shape[-1]
    a32 = a_s.float()
    z = iterative_pinv(a32, num_iters=pinv_iters)
    az = a32 @ z
    soft_rank = _trace(az)
    tail = _trace(a32) - _trace(az @ a32)
    denom = torch.clamp(c - soft_rank, min=1e-2)
    delta = torch.clamp(tail, min=0.0) / denom
    if not use_shift:
        delta = torch.zeros_like(delta)
    delta = delta[..., None, None]
    eye = torch.eye(c, dtype=torch.float32, device=a_s.device)
    u = z @ (eye - delta * z)
    return SSCore(u=u.to(a_s.dtype), delta=delta.to(a_s.dtype), z=z.to(a_s.dtype))
