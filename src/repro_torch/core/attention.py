"""Attention building blocks of ``repro/core/attention.py`` that the
serving path needs: the spectral-shift hyper-parameters, the masked fp32
softmax and exact softmax attention (the <= c prefill regime)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
