"""Mixture-of-Experts FFN (``repro/models/moe.py``): DeepSeek-V2 / Kimi-K2
style shared + routed experts, top-k, capacity-bounded token dropping.

Dispatch is k scatter-adds of the token block into a (B, E, cap, D) buffer
and k gathers back, as the reference does; the expert products are plain
batched matrix products (the reference leaves them to XLA: no Pallas
kernel). Every expert's weights are read whatever the routing, since the
buffer holds a capacity of slots for each. The expert-parallel
``moe_forward_ep`` (shard_map all-to-all) is multi-device and not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_forward, mlp_specs
from repro_torch.models.params import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    """``moe.py:21``."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    specs = {
        "router": ParamSpec((d, e), ("embed", None), scale=d**-0.5),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed_unsharded", "moe_ff")),
        "w_up": ParamSpec((e, d, f), ("experts", "embed_unsharded", "moe_ff")),
        "w_down": ParamSpec((e, f, d), ("experts", "moe_ff", "embed_unsharded")),
    }
    if cfg.num_shared_experts:
        specs["shared"] = mlp_specs(d, cfg.moe_d_ff * cfg.num_shared_experts, "swiglu")
    return specs


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Slots per (batch row, expert) (``moe.py:34``)."""
    c = int(seq_len * cfg.top_k * cfg.capacity_factor / cfg.num_experts) + 1
    return max(cfg.top_k, min(c, seq_len))


def route(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """The router of ``moe_forward``: x (B, S, D) -> fp32 gates (B, S, E),
    the top-k weights renormalised (B, S, k) and expert ids (B, S, k). The
    top k by a stable descending sort: among equal gates the lower expert
    id comes first, as ``jax.lax.top_k`` orders them."""
    gates = torch.softmax((x @ p["router"].to(x.dtype)).float(), dim=-1)
    top_w, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :cfg.top_k], top_i[..., :cfg.top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return gates, top_w, top_i


def dispatch_slots(cfg: ModelConfig, top_i: torch.Tensor, seq_len: int):
    """Token-order slot assignment (``moe.py:62-69``): each (token, choice)
    takes the next slot of its expert, counted by a cumsum over the S*k
    choices of its batch row; choices past the capacity are dropped.
    Returns (slot (B, S, k) clipped to the capacity, keep (B, S, k) bool)."""
    b, s, k = top_i.shape
    cap = capacity(cfg, seq_len)
    choice_hot = F.one_hot(top_i, cfg.num_experts).reshape(b, s * k, -1)
    pos = torch.cumsum(choice_hot, dim=1) - 1
    slot = (pos * choice_hot).sum(-1).reshape(b, s, k)
    keep = slot < cap
    return torch.clamp(slot, 0, cap - 1), keep


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, D) -> (out (B, S, D), fp32 aux load-balance loss)
    (``moe.py:39``)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(cfg, s)
    dt = x.dtype
    gates, top_w, top_i = route(p, cfg, x)

    # Load-balance aux loss (Switch-style): E * <f_e, p_e>.
    me = gates.mean(dim=(0, 1))
    fe = F.one_hot(top_i, e).float().sum(2).mean(dim=(0, 1)) / k
    aux = e * torch.sum(fe * me)

    slot, keep = dispatch_slots(cfg, top_i, s)
    keep = keep.to(dt)
    # Dispatch: k scatter-adds of the token block into (B, E, cap, D).
    buf = torch.zeros((b, e, cap, d), dtype=dt, device=x.device)
    b_idx = torch.arange(b, device=x.device)[:, None].expand(b, s)
    for j in range(k):
        buf.index_put_((b_idx, top_i[..., j], slot[..., j]), x * keep[..., j:j + 1],
                       accumulate=True)

    # Expert SwiGLU, batched over (B, E).
    h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"].to(dt))) * torch.einsum(
        "becd,edf->becf", buf, p["w_up"].to(dt))
    buf_out = torch.einsum("becf,efd->becd", h, p["w_down"].to(dt))

    # Combine: gather each choice's slot back and mix with its gate weight.
    out = torch.zeros_like(x)
    for j in range(k):
        gathered = buf_out[b_idx, top_i[..., j], slot[..., j]]
        out = out + gathered * (top_w[..., j, None].to(dt) * keep[..., j:j + 1])
    if cfg.num_shared_experts:
        out = out + mlp_forward(p["shared"], x, "swiglu")
    return out, aux.float()
