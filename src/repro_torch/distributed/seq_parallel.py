"""Sequence-parallel building blocks for the families that carry state
along the sequence: the mamba scan (Hymba), the mLSTM and sLSTM cells
(xLSTM) and their causal convs, and exact attention over keys that span
shards.

This module has no counterpart under ``src/repro/``. The reference runs
these families under a sequence shard as one GSPMD program: XLA sees the
whole sequence, and the collectives that carry a conv's context, a scan's
state or the keys across shards are derived from the sharded program
itself. Here every rank runs its own slice eagerly, so each crossing is an
explicit collective of a ``Mesh`` (``distributed/mesh.py``), which counts
it, and on an ``AbstractMesh`` records it for the dry-run. Each names its
backward, since torch transposes no collective:

* ``halo_exchange``: each shard's last ``rows`` rows, all-gathered; a
  rank keeps the previous shard's (zeros on shard 0, as ``F.pad`` gives
  the unsharded causal conv). Backward: the gather's (the cotangents
  summed over the ranks, each rank's own slice).
* ``affine_carry``: the incoming state of a recurrence h_t = a_t * h_{t-1}
  + b_t. Each shard gives its total decay A (the product of its a_t) and
  its end state from a zero start, both fp32; one all-gather, then every
  rank combines the earlier shards' pairs itself, with no serial wait.
* ``state_chain``: for a recurrence that does not combine (the sLSTM's
  gates are nonlinear in its state; the mLSTM's outputs divide by a
  function of it): shard r receives the state from shard r - 1, runs,
  and sends its final state to r + 1 (``distributed/pipeline.py``'s
  ``pipe_recv`` / ``pipe_send`` / ``pipe_tie``: blocking transfers whose
  backward runs the chain in reverse). The shards run one after another.

Every rank calls every collective, shard 0 and the last included, and
each result stays in the autograd graph on every rank (a shard that takes
zeros takes them by index from the gathered tensor), so the backward's
collectives pair up on every rank. The halo and the carry are
all-gathers, never point-to-point transfers: under remat the recompute
reruns a checkpointed layer's collectives on autograd's thread, in the
same order on every rank. The chain is point-to-point and is used only
where no remat reruns it (the ``ssm`` trunk).

``active_shard()`` is the rank's ``SeqShard`` under the active
logical-axis rules (``distributed/sharding.py``) when the sequence is
split over ranks, else None.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.distributed.pipeline import pipe_recv, pipe_send, pipe_tie


class _StackGather(torch.autograd.Function):
    """x from every rank of ``axes``, stacked on a new leading dim in
    flat-index order; backward, the cotangents summed over the ranks and
    this rank's slot taken."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.meta = (mesh, axes)
        return mesh.all_gather(x.contiguous()[None], axes, dim=0)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.meta
        g = mesh.all_reduce(g.contiguous(), "sum", axes)
        return g[mesh.index(axes)].contiguous(), None, None


def all_gather_stack(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """(shards, *x.shape): every rank's x over ``axes``; differentiable."""
    return _StackGather.apply(x, mesh, tuple(axes))


def halo_exchange(x: torch.Tensor, mesh, axes: Sequence[str], rows: int) -> torch.Tensor:
    """x (B, S_loc, C) -> (B, rows, C): the previous shard's last ``rows``
    rows, zeros on shard 0 (one all-gather of every shard's tail)."""
    if rows <= 0:
        return x[:, :0]
    if x.shape[1] < rows:
        raise ValueError(f"halo_exchange: a shard of {x.shape[1]} rows cannot give the "
                         f"next one its last {rows}")
    tails = all_gather_stack(x[:, -rows:], mesh, axes)            # (shards, B, rows, C)
    prev = torch.cat([torch.zeros_like(tails[:1]), tails[:-1]])   # shard i gets i - 1's
    return prev[mesh.index(axes)]


def affine_carry(a: torch.Tensor, b: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The state entering this shard of h_t = a_t * h_{t-1} + b_t from h = 0
    at the sequence's start. ``a``: the shard's total decay (the product of
    its a_t), ``b``: its end state from a zero start (fp32, one shape).
    One all-gather of both; then h_in of shard i = sum over j < i of (the
    product of the decays of shards j + 1 .. i - 1) * b_j, combined in
    shard order on every rank (zeros on shard 0)."""
    parts = all_gather_stack(torch.stack([a.float(), b.float()]), mesh, axes)
    h = torch.zeros_like(parts[0, 1])
    entering = [h]
    for j in range(parts.shape[0] - 1):
        h = parts[j, 0] * h + parts[j, 1]
        entering.append(h)
    return torch.stack(entering)[mesh.index(axes)]


def _pack(state: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in state])


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> tuple:
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return tuple(out)


def state_chain(run: Callable, fresh: Sequence[torch.Tensor], mesh, axes: Sequence[str],
                anchor: torch.Tensor):
    """``run(state) -> (out, final_state)`` on this shard, its state
    received from the previous shard (``fresh``, the recurrence's own
    start, on shard 0) and its final state sent to the next. States are
    tuples of tensors of ``fresh``'s shapes and dtype, moved as one flat
    buffer. ``anchor`` (a parameter the gradient is taken of) ties the
    receive into the backward's graph: its backward, which sends the
    state's cotangent back, must run on every rank, so the anchor must be
    among the tensors the gradient is taken of. ``out`` comes back
    tied to the send, whose backward receives the final state's cotangent
    before ``run``'s backward needs it. Returns (out, final_state)."""
    axes = tuple(axes)
    shards, i, mid = mesh.axis_size(axes), mesh.index(axes), mesh.mesh_id
    axis = ",".join(axes)
    fresh = tuple(fresh)
    state = fresh
    if i > 0:
        token = anchor.reshape(-1)[:1].sum().float() * 0
        state = _unpack(pipe_recv(token, _pack(fresh), mid, axis, i - 1), fresh)
    out, final = run(state)
    if i < shards - 1:
        out = pipe_tie(out, pipe_send(_pack(final), mid, axis, i + 1))
    return out, final


class SeqShard:
    """This rank's slice of a sequence split over the mesh axes ``axes``:
    ``index`` of ``count`` shards. Its methods are the building blocks
    above, on its mesh and axes (each looked up in this module at call
    time, so a control can replace one)."""

    def __init__(self, mesh, axes: Sequence[str]):
        self.mesh, self.axes = mesh, tuple(axes)
        self.count = mesh.axis_size(self.axes)
        self.index = mesh.index(self.axes)

    def halo(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        return halo_exchange(x, self.mesh, self.axes, rows)

    def carry(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return affine_carry(a, b, self.mesh, self.axes)

    def chain(self, run: Callable, fresh, anchor: torch.Tensor):
        return state_chain(run, fresh, self.mesh, self.axes, anchor)


def active_shard() -> Optional[SeqShard]:
    """The rank's ``SeqShard`` under the active rules when the "seq" rule
    splits the sequence over ranks; None otherwise."""
    from repro_torch.distributed.sharding import active_seq_sharding

    mesh, axes, _ = active_seq_sharding()
    return SeqShard(mesh, axes) if axes else None

