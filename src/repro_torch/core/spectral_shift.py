"""Modified Spectral Shifting core (paper §4, ``repro/core/spectral_shift.py``).

Given the landmark core ``A_s`` (c x c):

    delta_ss = ( tr(A_s) - tr(A_s^+ A_s^2) ) / ( c - rank(A_s) )
    U_ss     = A_s^+ (I - delta_ss A_s^+)

* ``method="svd"``: exact truncated pinv; rank = #(sigma > rank_tol *
  sigma_max), delta = mean of the discarded tail spectrum; with
  ``target_rank`` exactly the top ``target_rank`` values are kept (the
  Lemma-1 regime). The oracle path.
* ``method="iterative"``: the Newton-Schulz pinv Z*, soft rank tr(A Z*)
  and the tail mass as trace expressions of Z*. The kernels' path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.pinv import _promoted, iterative_pinv, svd_pinv


class SSCore(NamedTuple):
    """Spectral-shift factors: ``S ~= F @ u @ B + delta * I_n``."""

    u: torch.Tensor      # (..., c, c)  U_ss = Z (I - delta Z)
    delta: torch.Tensor  # (..., 1, 1)  spectral shift
    z: torch.Tensor      # (..., c, c)  the pseudoinverse estimate Z*


def _trace(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def ss_core(a_s: torch.Tensor, *, method: str = "iterative",
            pinv_iters: int = 6, rank_tol: float = 1e-3,
            target_rank: Optional[int] = None, use_shift: bool = True) -> SSCore:
    """``(U_ss, delta_ss, Z*)`` of the landmark core ``a_s`` (..., c, c),
    computed in at least fp32 and returned in ``a_s``'s dtype.
    ``use_shift=False`` forces delta = 0 (the Nystrom prototype model)."""
    c = a_s.shape[-1]
    a32 = _promoted(a_s)
    if method == "svd":
        if target_rank is not None:
            u_svd, s, vt = torch.linalg.svd(a32, full_matrices=False)
            keep = (torch.arange(c, device=a_s.device) < target_rank).expand_as(s)
            s_inv = torch.where(keep, 1.0 / torch.where(s > 1e-30, s, 1.0), 0.0)
            z = torch.einsum("...ji,...j,...kj->...ik", vt, s_inv, u_svd)
        else:
            z, keep, s = svd_pinv(a32, rank_tol=rank_tol)
        rank = keep.sum(dim=-1).to(a32.dtype)
        # tr(A) - tr(A^+ A^2) = the discarded singular values (SPSD view)
        tail = torch.where(keep, 0.0, s).sum(dim=-1)
        delta = tail / torch.clamp(c - rank, min=1.0)
    elif method == "iterative":
        z = iterative_pinv(a32, num_iters=pinv_iters)
        az = a32 @ z
        soft_rank = _trace(az)
        tail = _trace(a32) - _trace(az @ a32)
        delta = torch.clamp(tail, min=0.0) / torch.clamp(c - soft_rank, min=1e-2)
    else:
        raise ValueError(f"unknown ss_core method: {method!r}")
    if not use_shift:
        delta = torch.zeros_like(delta)
    delta = delta[..., None, None]
    eye = torch.eye(c, dtype=a32.dtype, device=a_s.device)
    u = z @ (eye - delta * z)
    return SSCore(u=u.to(a_s.dtype), delta=delta.to(a_s.dtype), z=z.to(a_s.dtype))
