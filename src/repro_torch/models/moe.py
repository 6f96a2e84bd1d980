"""Mixture-of-Experts FFN (``repro/models/moe.py``): DeepSeek-V2 / Kimi-K2
style shared + routed experts, top-k, capacity-bounded token dropping.

Dispatch is k scatter-adds of the token block into a (B, E, cap, D) buffer
and k gathers back, as the reference does; the expert products are plain
batched matrix products (the reference leaves them to XLA: no Pallas
kernel). Every expert's weights are read whatever the routing, since the
buffer holds a capacity of slots for each.

Over the ranks of a mesh (``distributed.sharding.sharding_rules``) each
rank holds its rows of the batch. ``moe_forward`` routes them as one
device would (capacity is per batch row) and averages the load-balance
loss's expert shares over the whole batch: the token means are summed
over the ranks that hold other rows before their product (an all-reduce
whose backward is an all-reduce too, since every rank's aux is the whole
batch's; ``models/model.py:loss_fn`` counts a rank's share of it).
``moe_forward_ep`` is the reference's explicit expert-parallel MoE
(``moe.py:97``): each rank runs its own experts on the tokens every rank
sends it, one all-to-all out and one back (``distributed/mesh.py``'s
``ep_all_to_all``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import ep_all_to_all, tp_copy, tp_reduce
from repro_torch.distributed.sharding import active_mesh, active_reduce_axes, expert_axes
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

    # Load-balance aux loss (Switch-style): E * <f_e, p_e>, over the whole
    # batch when its rows are split over ranks.
    me = gates.mean(dim=(0, 1))
    fe = F.one_hot(top_i, e).float().sum(2).mean(dim=(0, 1)) / k
    me, fe = batch_means(me, fe, *active_reduce_axes())
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


# (routed, kept) (token, choice) slots of ``moe_forward_ep`` since the last
# reset, one int64 pair a device, added on the device (no host sync);
# ``slot_counts`` reads them. A recomputed forward (remat) counts again, so
# the kept share stays the forward's.
_SLOTS: dict = {}


def slot_counts() -> tuple[int, int]:
    """(routed, kept) slots of ``moe_forward_ep`` since ``reset_slot_counts``."""
    total = [int(v[i]) for v in _SLOTS.values() for i in (0, 1)]
    return sum(total[0::2]), sum(total[1::2])


def reset_slot_counts() -> None:
    _SLOTS.clear()


def batch_means(me: torch.Tensor, fe: torch.Tensor, mesh, axes: tuple):
    """The expert shares ``me`` (gates, differentiable) and ``fe`` (top-k
    counts) of a rank's tokens averaged over the ranks of ``axes``, which
    hold equal shares of the batch's tokens: one all-reduce of both, whose
    backward sums the cotangents over the same ranks (``tp_copy`` of
    ``tp_reduce``), since every rank's aux then depends on every rank's
    gates. As they are without a mesh or over one rank."""
    if mesh is None or mesh.axis_size(axes) == 1:
        return me, fe
    ax = ",".join(axes)
    both = torch.cat([me, fe])
    both = tp_copy(tp_reduce(both, mesh.mesh_id, ax), mesh.mesh_id, ax) / mesh.axis_size(axes)
    return both[:me.shape[0]], both[me.shape[0]:]


def moe_forward_ep(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Expert-parallel MoE (``moe.py:97``): x (B, S, D), this rank's rows
    -> (out (B, S, D), fp32 aux). Falls back to ``moe_forward`` where the
    reference does: no active mesh or no "data" axis, or experts that do
    not tile the expert axes (``sharding.expert_axes``: every axis but
    "model", dp ranks).

    The rank routes its t = B·S tokens; the aux loss takes the gate and
    count means over the expert axes before their product. Capacity is per
    source shard and expert, ``int(t·k·cf / E) + 1`` at least k, padded to a
    multiple of the "model" axis (tp ranks); slots are taken choice-major
    (k passes over the tokens, each continuing every expert's count), and
    "model" rank m fills and sends only its band of cap / tp slots. The
    (dp, E / dp, cap / tp, D) buckets go to the ranks that own their
    experts in one all-to-all; the rank's experts run their SwiGLU on
    (E / dp, dp·cap / tp, D) with the whole ``moe_ff``; the inverse
    all-to-all returns them; the k choices are combined in fp32, masked
    to the band, summed over "model" (``tp_reduce``) and the shared
    experts added. The expert leaves may be whole (E, ...) or the rank's
    (E / dp, ...) slice of a parameter layout. Where the bands split over
    "model", the token block, the gate weights and the expert weights
    enter the band's work through ``tp_copy``: each rank's cotangent is
    its band's share."""
    mesh = active_mesh()
    if mesh is None or "data" not in mesh.axis_names:
        return moe_forward(p, cfg, x)
    ep_axes = expert_axes(mesh)
    dp, tp = mesh.axis_size(ep_axes), mesh.shape.get("model", 1)
    e, k = cfg.num_experts, cfg.top_k
    if e % dp:
        return moe_forward(p, cfg, x)   # experts must tile the expert axes
    e_loc, mid, ep = e // dp, mesh.mesh_id, ",".join(ep_axes)
    b, s, d = x.shape
    t, dt = b * s, x.dtype
    xt = x.reshape(t, d)
    gates, top_w, top_i = route(p, cfg, xt)
    me = gates.mean(0)
    fe = F.one_hot(top_i, e).float().sum(1).mean(0) / k
    me, fe = batch_means(me, fe, mesh, ep_axes)
    aux = e * torch.sum(fe * me)

    cap = max(int(t * k * cfg.capacity_factor / e) + 1, k)
    cap = -(-cap // tp) * tp
    band = cap // tp
    base = torch.zeros(e, dtype=torch.int64, device=x.device)
    slots, keeps = [], []
    for j in range(k):   # choice-major slots: (T, E) a pass
        oh = F.one_hot(top_i[:, j], e)
        pos = torch.cumsum(oh, 0) - 1 + base
        slots.append((pos * oh).sum(-1))
        base = base + oh.sum(0)
        keeps.append(slots[-1] < cap)
    counts = _SLOTS.setdefault(x.device, torch.zeros(2, dtype=torch.int64, device=x.device))
    counts[0] += t * k
    counts[1] += torch.stack(keeps).sum()

    experts = [p[n] if p[n].shape[0] == e_loc else
               p[n][mesh.index(ep_axes) * e_loc:(mesh.index(ep_axes) + 1) * e_loc]
               for n in ("w_gate", "w_up", "w_down")]
    if tp > 1:
        midx = mesh.coords["model"]
        xt_band, top_w = tp_copy(xt, mid, "model"), tp_copy(top_w, mid, "model")
        experts = [tp_copy(w, mid, "model") for w in experts]
    else:
        midx, xt_band = 0, xt
    send = torch.zeros((dp, e_loc, band, d), dtype=dt, device=x.device)
    where, uses = [], []
    for j in range(k):
        ej, slot = top_i[:, j], torch.clamp(slots[j], 0, cap - 1)
        use = keeps[j] & (slot // band == midx)
        where.append((ej // e_loc, ej % e_loc, slot % band))
        uses.append(use)
        send = send.index_put(where[-1], xt_band * use[:, None].to(dt), accumulate=True)

    recv = ep_all_to_all(send, mid, ep) if dp > 1 else send   # dim 0: source shard
    buf = recv.transpose(0, 1).reshape(e_loc, dp * band, d)
    w_gate, w_up, w_down = (w.to(dt) for w in experts)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w_gate)) * torch.einsum(
        "ecd,edf->ecf", buf, w_up)
    out = torch.einsum("ecf,efd->ecd", h, w_down)
    out = out.reshape(e_loc, dp, band, d).transpose(0, 1).contiguous()
    back = ep_all_to_all(out, mid, ep) if dp > 1 else out   # dim 0: destination shard

    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        wj = top_w[:, j] * uses[j].float()
        y = y + back[where[j]].float() * wj[:, None]
    if tp > 1:
        y = tp_reduce(y, mid, "model")
    y = y.to(dt)
    if cfg.num_shared_experts:
        y = y + mlp_forward(p["shared"], xt, "swiglu")
    return y.reshape(b, s, d), aux.float()
