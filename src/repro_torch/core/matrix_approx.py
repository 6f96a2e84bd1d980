"""SPSD matrix approximation models from the paper's lineage
(``repro/core/matrix_approx.py``), over the same sampled columns
``C = K[:, cols]`` and core ``A = K[cols][:, cols]``:

* ``prototype`` (Nystrom, paper §2.2):   K ~= C A^+ C^T
* ``modified_ss`` (paper §4, eq. (10)):  K ~= C U_ss C^T + d I, d fitted on
  the sampled core alone
* ``modified_ss_shifted`` (paper §4, the K - d I branch): C~ = C - d P,
  A~ = A - d I, still column-only; exact under Lemma 1's flat tail.

O(n^2) on purpose: these measure approximation error on explicit
matrices; the linear-time attention lives in ``core/attention.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.pinv import svd_pinv
from repro_torch.core.spectral_shift import ss_core


def sample_columns(n: int, c: int) -> torch.Tensor:
    """Deterministic uniform (segment-stride) column indices, c of n."""
    return torch.arange(c) * (n // c)


def approximate_spsd(k_mat: torch.Tensor, cols: torch.Tensor,
                     model: str = "modified_ss", *,
                     target_rank: Optional[int] = None,
                     rank_tol: float = 1e-3) -> torch.Tensor:
    """Approximate SPSD ``k_mat`` (n, n) from columns ``cols`` per ``model``."""
    n = k_mat.shape[-1]
    c = cols.shape[0]
    cols = cols.to(k_mat.device)
    c_mat = k_mat[:, cols]              # C (n, c)
    a_mat = c_mat[cols, :]              # A (c, c)
    eye_n = torch.eye(n, dtype=k_mat.dtype, device=k_mat.device)
    if model == "prototype":
        pinv, _, _ = svd_pinv(a_mat, rank_tol=rank_tol)
        return c_mat @ pinv @ c_mat.T
    if model not in ("modified_ss", "modified_ss_shifted"):
        raise ValueError(f"unknown approximation model: {model!r}")
    core = ss_core(a_mat, method="svd", rank_tol=rank_tol, target_rank=target_rank)
    delta = core.delta[..., 0, 0]
    if model == "modified_ss":
        return c_mat @ core.u @ c_mat.T + delta * eye_n
    sel = torch.zeros((n, c), dtype=k_mat.dtype, device=k_mat.device)
    sel[cols, torch.arange(c, device=k_mat.device)] = 1.0
    c_shift = c_mat - delta * sel
    a_shift = a_mat - delta * torch.eye(c, dtype=k_mat.dtype, device=k_mat.device)
    pinv, _, _ = svd_pinv(a_shift, rank_tol=rank_tol)
    return c_shift @ pinv @ c_shift.T + delta * eye_n


def flat_tail_spsd(n: int, head_rank: int, theta: float, seed: int = 0,
                   head_max: float = 8.0) -> torch.Tensor:
    """The Lemma-1 spectrum: a top-``head_rank`` head and an exactly flat
    tail at ``theta``, as fp32 (n, n). numpy's generator and QR make it, as
    in the reference, so both packages build the same matrix."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.concatenate([np.linspace(head_max, 1.0, head_rank),
                          theta * np.ones(n - head_rank)])
    return torch.as_tensor((q * lam) @ q.T, dtype=torch.float32)
