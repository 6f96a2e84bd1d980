"""Common neural layers (plain functions over parameter dicts).

Mirrors ``repro/models/layers.py`` for the dense decoder: RMS norm, rotary
embeddings (rotate-half) and the SwiGLU MLP.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``repro/models/layers.py:10``: fp32 statistics, output in x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def rotary_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., n) -> (sin, cos) of shape (..., n, head_dim/2)."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=positions.device) / head_dim
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (..., n, d) with (sin, cos) (..., n, d/2); rotate-half convention."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_specs(d_model: int, d_ff: int, act: str) -> dict:
    if act != "swiglu":
        raise NotImplementedError(f"act {act!r} is not ported yet")
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "w_down": ParamSpec((d_ff, d_model), ("ff", "embed")),
    }


def mlp_forward(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act != "swiglu":
        raise NotImplementedError(f"act {act!r} is not ported yet")
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)
