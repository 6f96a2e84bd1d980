"""Segment-means landmark selection (paper §2.3, eq. (1)).

Mirrors ``repro/core/landmarks.py``: ``n`` tokens are split into ``m``
contiguous segments of length ``ceil(n / m)`` and each segment is
mean-pooled, dividing by the true per-segment counts when ``m`` does not
divide ``n``.
"""
from __future__ import annotations

import torch


def onehot_segment_sums(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """``onehot`` (m, n) . ``x`` (..., n, d) -> fp32 (..., m, d), the one
    formula behind every landmark-sum site (``landmarks.py:14``)."""
    xf = x.float()
    return torch.matmul(onehot.to(xf.dtype), xf)


def segment_counts(n_valid, num_landmarks: int, seg, floor: int = 1,
                   device=None) -> torch.Tensor:
    """True per-segment token counts (m,) fp32 for ``n_valid`` tokens split
    into segments of length ``seg`` (``landmarks.py:28``). ``n_valid`` may
    be an int or a tensor (..., ) of per-lane counts, giving (..., m).
    ``floor=0`` keeps empty segments at 0 so validity stays derivable."""
    if isinstance(n_valid, torch.Tensor):
        device = n_valid.device
        n_valid = n_valid[..., None]
    j = torch.arange(num_landmarks, device=device)
    return torch.clamp(n_valid - j * seg, min=floor, max=seg).float()


def segment_means(x: torch.Tensor, num_landmarks: int,
                  via_matmul: bool = False) -> torch.Tensor:
    """Mean-pool ``x`` (..., n, d) into (..., m, d) segment means
    (``landmarks.py:39``); n <= m returns ``x`` (every token a landmark)."""
    n, d = x.shape[-2], x.shape[-1]
    m = int(num_landmarks)
    if m <= 0:
        raise ValueError(f"num_landmarks must be positive, got {m}")
    if n <= m:
        return x
    seg = -(-n // m)
    pad = seg * m - n
    counts = segment_counts(n, m, seg, device=x.device) if pad else float(seg)
    if via_matmul:
        onehot = (torch.arange(n, device=x.device) // seg
                  == torch.arange(m, device=x.device)[:, None])
        sums = onehot_segment_sums(x, onehot)
    else:
        xf = x.float()
        if pad:
            xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
        sums = xf.reshape(*x.shape[:-2], m, seg, d).sum(dim=-2)
    means = sums / (counts[:, None] if pad else counts)
    return means.to(x.dtype)


def masked_segment_means(x: torch.Tensor, num_landmarks: int,
                         n_valid: int) -> torch.Tensor:
    """Segment means of ``x[..., :n_valid, :]`` computed on the full padded
    array (``landmarks.py:81``): positions >= n_valid are excluded and the
    segment length is ``ceil(n_valid / m)``, as the unpadded call uses.
    Requires ``n_valid > m``."""
    n = x.shape[-2]
    m = int(num_landmarks)
    if m <= 0:
        raise ValueError(f"num_landmarks must be positive, got {m}")
    n_valid = int(n_valid)
    seg = -(-n_valid // m)
    pos = torch.arange(n, device=x.device)
    onehot = (((pos // seg)[None, :] == torch.arange(m, device=x.device)[:, None])
              & (pos < n_valid)[None, :])
    sums = onehot_segment_sums(x, onehot)
    counts = segment_counts(n_valid, m, seg, device=x.device)
    return (sums / counts[:, None]).to(x.dtype)


def segment_of(position: torch.Tensor, n: int, num_landmarks: int) -> torch.Tensor:
    """Map token positions (0..n-1) to their landmark segment index."""
    seg = -(-n // num_landmarks)
    return position // seg
