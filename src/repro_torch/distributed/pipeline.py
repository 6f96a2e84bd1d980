"""GPipe pipeline parallelism over the ranks of a ``Mesh`` axis
(``repro/distributed/pipeline.py``).

The reference runs the classic fill-drain schedule as a ``lax.scan`` over
``num_micro + num_stages - 1`` ticks inside ``shard_map``: at tick t stage
s computes microbatch t - s, the activations rotate one stage a tick by
``ppermute`` and the last stage's outputs are psum-broadcast. Here every
rank is one stage and runs its own part of that schedule eagerly: its
microbatches in order, each received from stage s - 1 (stage 0 takes the
microbatch itself), run through its layers and sent to stage s + 1; the
last stage's outputs are then broadcast. The ticks whose result the
reference discards are not run: the bubble's (a stage with no microbatch
yet or any more), the clipped ``mb_idx``'s and the ring's wrap-around from
the last stage to stage 0. The outputs are the same.

Gradients flow through the ranks with autograd. Torch transposes no
collective, so each transfer is a custom op that names its backward
(``repro_torch::pipe_send``: send forward, receive the cotangent
backward; ``::pipe_recv``: the reverse; ``::pipe_broadcast``: broadcast
forward, and backward the cotangent on the last stage alone, since every
rank computes the same loss from the replicated output and the loss
counts once). Blocking transfers must pair up in the same order on both
sides: each microbatch's input takes the previous microbatch's token
(the output of ``pipe_send``, or of ``pipe_tie`` on stage 0), so autograd
runs every stage's backward microbatch by microbatch from the last, and
the broadcast takes the last token, so that the backward reaches every
send. On an ``AbstractMesh`` the transfers' fake implementations record
them, as the mesh's collectives do, so the dry-run counts them (the
sequence-sharded xLSTM's state chain, ``distributed/seq_parallel.py``).

    stacked = stack_stages(layers, num_stages)          # leaves (S, L/S, ...)
    forward = make_pipeline_forward(layer_fn, mesh, "pipe")
    out = forward(stacked, microbatches)                # (M, mb, ...) everywhere
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.mesh import _split_axes, abstract_mesh, mesh_by_id
from repro_torch.models.params import tree_leaves, tree_map


def stack_stages(layer_params_list: list, num_stages: int):
    """[L layer trees] -> one tree with leaves (num_stages, L / num_stages,
    ...) (``pipeline.py:35``)."""
    n = len(layer_params_list)
    if n % num_stages:
        raise ValueError(f"{n} layers not divisible into {num_stages} stages")
    stacked = tree_map(lambda *xs: torch.stack(xs), *layer_params_list)
    return tree_map(lambda x: x.reshape(num_stages, n // num_stages, *x.shape[1:]), stacked)


def make_pipeline_forward(layer_fn: Callable, mesh, axis: str = "pipe"):
    """``f(stage_params, microbatches) -> outputs`` (``pipeline.py:46``).

    ``layer_fn(layer_params, x) -> x`` is one layer, keeping x's shape and
    dtype; a stage runs it over its layers in order. ``stage_params``: the
    stacked tree of ``stack_stages`` (leaves (S, L/S, ...)) or this rank's
    stage of it (leaves (1, L/S, ...), what the reference's ``shard_body``
    sees); ``microbatches`` (M, mb, ...), the same on every rank. Returns
    (M, mb, ...), the last stage's outputs, on every rank of ``axis``."""
    num_stages = mesh.shape[axis]
    stage = mesh.coords[axis]
    mid = mesh.mesh_id

    def stage_fn(local_layers, x):
        for i in range(tree_leaves(local_layers)[0].shape[0]):
            x = layer_fn(tree_map(lambda t: t[i], local_layers), x)
        return x

    def pipeline_forward(stage_params, microbatches):
        lead = tree_leaves(stage_params)[0].shape[0]
        if lead not in (1, num_stages):
            raise ValueError(f"pipeline: stage params lead with {lead}, neither this "
                             f"rank's stage (1) nor every stage ({num_stages})")
        local = tree_map(lambda t: t[stage if lead > 1 else 0], stage_params)
        grad = torch.is_grad_enabled() and (microbatches.requires_grad or any(
            t.requires_grad for t in tree_leaves(local)))
        # the token chain that orders the transfers' backwards
        token = torch.zeros((), device=microbatches.device, requires_grad=grad)
        ys = []
        for i in range(microbatches.shape[0]):
            if stage == 0:
                x = pipe_tie(microbatches[i], token)
            else:
                x = pipe_recv(token, microbatches[i], mid, axis, stage - 1)
            y = stage_fn(local, x)
            token = pipe_send(y, mid, axis, stage + 1 if stage < num_stages - 1 else -1)
            ys.append(y)
        last = (torch.stack(ys) if stage == num_stages - 1
                else torch.zeros_like(microbatches))
        return pipe_broadcast(last, token, mid, axis, num_stages - 1)

    return pipeline_forward


def reference_forward(layer_fn: Callable, layer_params_list: list, x: torch.Tensor):
    """The sequential oracle (``pipeline.py:116``): every layer on the full
    batch."""
    for lp in layer_params_list:
        x = layer_fn(lp, x)
    return x


# --------------------------------------------------------------------------
# The transfers, as ops with their backwards.
# --------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::pipe_send", mutates_args=())
def pipe_send(x: torch.Tensor, mesh_id: int, axis: str, dst: int) -> torch.Tensor:
    """Send x to stage ``dst`` of ``axis`` (none when dst < 0: the last
    stage) and return a token; backward, receive x's cotangent from
    ``dst`` (zeros for none)."""
    if dst >= 0:
        mesh_by_id(mesh_id).send(x, _split_axes(axis), dst)
    return torch.zeros((), dtype=torch.float32, device=x.device)


@pipe_send.register_fake
def _(x, mesh_id, axis, dst):
    if dst >= 0 and abstract_mesh(mesh_id) is not None:   # the dry-run records it
        abstract_mesh(mesh_id).send(x, _split_axes(axis), dst)
    return x.new_empty((), dtype=torch.float32)


def _send_setup(ctx, inputs, output):
    x, ctx.mesh_id, ctx.axis, ctx.dst = inputs
    ctx.like = torch.empty_like(x, device="meta")
    ctx.device = x.device


def _send_backward(ctx, _g):
    if ctx.dst < 0:
        return None, None, None, None
    like = torch.empty(ctx.like.shape, dtype=ctx.like.dtype, device=ctx.device)
    return mesh_by_id(ctx.mesh_id).recv(like, _split_axes(ctx.axis), ctx.dst), None, None, None


pipe_send.register_autograd(_send_backward, setup_context=_send_setup)


@torch.library.custom_op("repro_torch::pipe_recv", mutates_args=())
def pipe_recv(token: torch.Tensor, like: torch.Tensor, mesh_id: int, axis: str,
              src: int) -> torch.Tensor:
    """A tensor of ``like``'s shape and dtype received from stage ``src``
    of ``axis``, after ``token`` (the previous transfer's); backward, send
    its cotangent back to ``src``."""
    return mesh_by_id(mesh_id).recv(like, _split_axes(axis), src)


@pipe_recv.register_fake
def _(token, like, mesh_id, axis, src):
    if abstract_mesh(mesh_id) is not None:   # the dry-run records it
        return abstract_mesh(mesh_id).recv(like, _split_axes(axis), src)
    return torch.empty_like(like)


def _recv_setup(ctx, inputs, output):
    ctx.meta = inputs[2:]


def _recv_backward(ctx, g):
    mesh_id, axis, src = ctx.meta
    mesh_by_id(mesh_id).send(g.contiguous(), _split_axes(axis), src)
    return torch.zeros((), device=g.device), None, None, None, None


pipe_recv.register_autograd(_recv_backward, setup_context=_recv_setup)


@torch.library.custom_op("repro_torch::pipe_tie", mutates_args=())
def pipe_tie(x: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """x (a copy), after ``token``: stage 0's place in the token chain."""
    return x.clone()


@pipe_tie.register_fake
def _(x, token):
    return torch.empty_like(x)


pipe_tie.register_autograd(lambda ctx, g: (g, torch.zeros((), device=g.device)),
                           setup_context=lambda ctx, inputs, output: None)


@torch.library.custom_op("repro_torch::pipe_broadcast", mutates_args=())
def pipe_broadcast(x: torch.Tensor, token: torch.Tensor, mesh_id: int, axis: str,
                   src: int) -> torch.Tensor:
    """Stage ``src``'s x on every stage of ``axis``, after ``token``;
    backward, the cotangent as it is on ``src`` and zeros elsewhere (every
    stage holds the same loss of the output: it counts once)."""
    return mesh_by_id(mesh_id).broadcast(x, _split_axes(axis), src)


@pipe_broadcast.register_fake
def _(x, token, mesh_id, axis, src):
    return torch.empty_like(x)


def _broadcast_backward(ctx, g):
    mesh_id, axis, src = ctx.meta
    mine = mesh_by_id(mesh_id).coords[axis] == src
    return (g if mine else torch.zeros_like(g)), torch.zeros((), device=g.device), None, \
        None, None


pipe_broadcast.register_autograd(_broadcast_backward, setup_context=_recv_setup)
