"""The Mamba (S6) selective SSM of the hybrid family
(``repro/models/ssm.py``): the depthwise causal conv, the parameter specs
and the chunked selective scan the trainer runs. One-token decode lives in
``serve/decode.py:mamba_decode``. The xLSTM cells (mLSTM, sLSTM) come with
the ``ssm`` family.

The reference scans in XLA (``lax.associative_scan`` within a chunk,
``lax.scan`` across chunks), not in Pallas, so this stays plain torch:
within a chunk a log-depth (Hillis-Steele) pass of elementwise ops over
(B, nc, L, di, N), every chunk at once; across chunks a sequential carry of
the (B, di, N) state. The association order differs from the reference's
tree, so results agree to rounding, not bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv (``ssm.py:19``). x (B,S,C), w (W,C), b (C)."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def mamba_specs(d_model: int, d_inner: int, state: int, conv_width: int,
                dt_rank: int) -> dict:
    """``ssm.py:195``."""
    return {
        "w_in": ParamSpec((d_model, 2 * d_inner), ("embed", "ff")),
        "conv_w": ParamSpec((conv_width, d_inner), (None, "ff"), scale=0.3),
        "conv_b": ParamSpec((d_inner,), ("ff",), init="zeros"),
        "w_bc": ParamSpec((d_inner, 2 * state), ("ff", None)),
        "w_dt": ParamSpec((d_inner, dt_rank), ("ff", None)),
        "w_dt_out": ParamSpec((dt_rank, d_inner), (None, "ff")),
        "b_dt": ParamSpec((d_inner,), ("ff",), init="zeros"),
        "a_log": ParamSpec((d_inner, state), ("ff", None), init="zeros"),
        "d_skip": ParamSpec((d_inner,), ("ff",), init="ones"),
        "w_out": ParamSpec((d_inner, d_model), ("ff", "embed")),
    }


def _linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along ``dim`` from h = 0:
    returns (prod of a up to t, h_t). Hillis-Steele: ceil(log2 L) passes,
    each combining every position with the one ``off`` before it; slices
    and a concatenation, so autograd keeps only each pass's inputs."""
    n = a.shape[dim]
    off = 1
    while off < n:
        head_a, head_b = a.narrow(dim, 0, off), b.narrow(dim, 0, off)
        cur_a, cur_b = a.narrow(dim, off, n - off), b.narrow(dim, off, n - off)
        prev_a, prev_b = a.narrow(dim, 0, n - off), b.narrow(dim, 0, n - off)
        b = torch.cat([head_b, cur_a * prev_b + cur_b], dim=dim)
        a = torch.cat([head_a, cur_a * prev_a], dim=dim)
        off *= 2
    return a, b


def mamba_forward(p: dict, x: torch.Tensor, state_dim: int, chunk: int = 256,
                  state: Optional[tuple] = None):
    """Selective SSM (``ssm.py:210``). x (B,S,D) -> (out (B,S,D),
    (h_final (B,di,N) fp32, conv_state (B,W-1,di))). ``state`` is an
    optional input ``(h0, conv_state)``. ``abar`` / ``bbar`` are computed
    in fp32 and stored in the compute dtype, as the reference stores
    them; the scan upcasts again."""
    b, s, _ = x.shape
    dt = x.dtype
    ui = x @ p["w_in"].to(dt)                                   # (B,S,2di)
    di = ui.shape[-1] // 2
    u, z = ui[..., :di], ui[..., di:]
    width = p["conv_w"].shape[0]
    if state is not None and state[1] is not None:
        ctx = torch.cat([state[1].to(dt), u], dim=1)
        u_conv = _causal_conv(ctx, p["conv_w"], p["conv_b"])[:, width - 1:]
        conv_state = ctx[:, -(width - 1):]
    else:
        u_conv = _causal_conv(u, p["conv_w"], p["conv_b"])
        conv_state = F.pad(u, (0, 0, width - 1, 0))[:, -(width - 1):]
    u_conv = F.silu(u_conv)

    bc = u_conv @ p["w_bc"].to(dt)                              # (B,S,2N)
    b_mat, c_mat = bc[..., :state_dim], bc[..., state_dim:]
    dt_pre = (u_conv @ p["w_dt"].to(dt)) @ p["w_dt_out"].to(dt)
    delta = F.softplus(dt_pre.float() + p["b_dt"].float())      # (B,S,di)
    a = -torch.exp(p["a_log"].float())                          # (di,N)
    abar = torch.exp(delta[..., None] * a).to(dt)               # (B,S,di,N)
    bbar = (delta[..., None] * b_mat.float()[..., None, :]
            * u_conv.float()[..., None]).to(dt)

    h0 = (torch.zeros((b, di, state_dim), dtype=torch.float32, device=x.device)
          if state is None else state[0].float())
    pad = -s % chunk
    if pad:
        abar = F.pad(abar, (0, 0, 0, 0, 0, pad), value=1.0)
        bbar = F.pad(bbar, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk
    acum, bcum = _linear_scan(abar.float().reshape(b, nc, chunk, di, state_dim),
                              bbar.float().reshape(b, nc, chunk, di, state_dim), 2)
    # the carry into each chunk: h after the previous chunk's last position
    carries, h = [], h0
    for j in range(nc):
        carries.append(h)
        h = acum[:, j, -1] * h + bcum[:, j, -1]
    hs = acum * torch.stack(carries, dim=1)[:, :, None] + bcum  # (B,nc,L,di,N)
    hs = hs.reshape(b, nc * chunk, di, state_dim)[:, :s]
    y = torch.einsum("bsdn,bsn->bsd", hs, c_mat.float())
    y = y + p["d_skip"].float() * u_conv.float()
    out = (y.to(dt) * F.silu(z)) @ p["w_out"].to(dt)
    return out, (h, conv_state)
