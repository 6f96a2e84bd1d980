"""Common neural layers (plain functions over parameter dicts).

Mirrors ``repro/models/layers.py``: RMS norm and LayerNorm, rotary
embeddings (rotate-half), whisper's sinusoidal positions, and the SwiGLU
MLP or the gelu MLP with biases.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import tp_copy
from repro_torch.distributed.sharding import active_layout, logical_constraint
from repro_torch.models.params import ParamSpec


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``repro/models/layers.py:10``: fp32 statistics, output in x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """``layers.py:17``: fp32 statistics with the population variance,
    output in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


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


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Fixed sinusoidal embeddings of the whisper encoder (``layers.py:46``):
    (n, d) fp32, sines then cosines."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (the erf form
    differs by about 1e-3)."""
    return F.gelu(x, approximate="tanh")


def mlp_specs(d_model: int, d_ff: int, act: str) -> dict:
    """``layers.py:57``: SwiGLU, or any other ``act`` the gelu MLP with
    biases."""
    if act == "swiglu":
        return {
            "w_gate": ParamSpec((d_model, d_ff), ("embed", "ff")),
            "w_up": ParamSpec((d_model, d_ff), ("embed", "ff")),
            "w_down": ParamSpec((d_ff, d_model), ("ff", "embed")),
        }
    return {
        "w_up": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "b_up": ParamSpec((d_ff,), ("ff",), init="zeros"),
        "w_down": ParamSpec((d_ff, d_model), ("ff", "embed")),
        "b_down": ParamSpec((d_model,), ("embed",), init="zeros"),
    }


def mlp_forward(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """``layers.py:72``. Under tensor parallelism (the hidden width split
    over the "model" axes, ``distributed.sharding.active_layout``)
    ``w_gate`` / ``w_up`` / ``b_up`` are column-parallel slices, x enters
    them through ``tp_copy`` and the row-parallel ``w_down`` product is
    summed over the width's axes before ``b_down``."""
    layout = active_layout()
    axes = layout.tp.ff if layout is not None else ()
    if axes:
        x = tp_copy(x, layout.mesh.mesh_id, ",".join(axes))
    dt = x.dtype
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return _row_sum(h @ p["w_down"].to(dt), axes)
    h = gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
    return _row_sum(h @ p["w_down"].to(dt), axes) + p["b_down"].to(dt)


def _row_sum(y: torch.Tensor, axes: tuple) -> torch.Tensor:
    """A row-parallel product's partial sums over ``axes`` summed."""
    return logical_constraint(y, ("batch", "seq", "embed_act"), partial=axes)
