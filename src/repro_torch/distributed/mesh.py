"""Device meshes over a ``torch.distributed`` group.

A ``Mesh`` is the port's counterpart of ``jax.sharding.Mesh``: named axes
and their sizes over the ranks of an initialised process group, laid out
row-major (rank = ((i0 * s1) + i1) * s2 + ...). It holds this rank's
coordinates, one subgroup per set of axes (created at construction, by
every rank in the same order, so that no rank ever creates a group alone)
and the rank's device, the card unless the caller asks for the CPU.
Collectives go through ``Mesh.all_reduce`` / ``Mesh.all_gather``, which
also count the seconds spent in them.

Backends. The backend is the process group's, the caller's choice:

* ``"gloo"`` on the CPU, and for ranks that share one GPU: NCCL will not
  put two ranks of one communicator on the same device. Under gloo a CUDA
  operand is staged through host memory on every call (a copy to the host,
  the collective there, a copy back): the sharded attention's operands are
  landmark-sized, (c, d) a batch-head, and the trainer's gradients go as
  one flat buffer a step. The staging waits for the device anyway; the
  count waits for it first, so that no compute is counted.
* ``"nccl"`` for ranks that each own a GPU; operands stay on the device
  and nothing waits for it: the seconds are CUDA events on the caller's
  stream, read when ``collective_seconds`` is.

The launch layer (``launch/mesh.py``) builds meshes and spawns local ranks;
the context-parallel attention's custom ops (``kernels/sharded.py``), which
cannot take a process group as an argument, find a mesh by ``mesh_id``.
"""
from __future__ import annotations

import datetime
import itertools
import math
import time
import weakref
from typing import Sequence

import torch
import torch.distributed as dist

# Seconds a collective may wait for a peer before it fails (every group).
DEFAULT_TIMEOUT_S = 300.0

# mesh_id -> Mesh; a mesh leaves it when it is collected
_MESHES: "weakref.WeakValueDictionary[int, Mesh]" = weakref.WeakValueDictionary()


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps axis name -> size (in ``axis_names`` order, like
    ``jax.sharding.Mesh.shape``); ``coords`` maps axis name -> this rank's
    index along it. ``group(axes)`` is the subgroup of the ranks that share
    this rank's coordinates on every other axis. ``device`` is "cuda" (this
    process's current GPU) unless the caller asks for "cpu"; CUDA without a
    GPU raises. ``mesh_id`` identifies the mesh to the custom ops of
    ``kernels/sharded.py``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S):
        if not dist.is_initialized():
            raise RuntimeError("Mesh: initialise torch.distributed first "
                               "(init_process_group, or launch.mesh.spawn_local)")
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"Mesh: shape {shape} and axis names {axis_names} disagree")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"Mesh: shape {shape} has {math.prod(shape)} ranks, the "
                             f"process group {world}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Mesh: device 'cuda' requested but no GPU is "
                                   "available; pass device='cpu'")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.coords = dict(zip(axis_names, _unravel(self.rank, shape)))
        self._host_seconds = 0.0
        self._events: list = []          # (start, end) CUDA events of unstaged collectives
        self.collective_calls = 0
        timeout = datetime.timedelta(seconds=timeout_s)
        self._groups: dict[tuple, object] = {}
        # every non-empty set of axes, in one order on every rank: new_group
        # is collective over the whole world, for every block
        for size in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, size):
                if len(axes) == len(axis_names):
                    self._groups[axes] = dist.group.WORLD
                    continue
                mine = None
                for block in _blocks(shape, axis_names, axes):
                    g = dist.new_group(block, timeout=timeout)
                    if self.rank in block:
                        mine = g
                self._groups[axes] = mine
        self.mesh_id = id(self)
        _MESHES[self.mesh_id] = self

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def collective_seconds(self) -> float:
        """Seconds spent in this mesh's collectives so far (reading it waits
        for the device collectives it has not timed yet)."""
        for start, end in self._events:
            end.synchronize()
            self._host_seconds += start.elapsed_time(end) / 1e3
        self._events.clear()
        return self._host_seconds

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"Mesh: unknown axes {unknown}; the mesh has {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        """Ranks spanned by ``axes`` (a name or a tuple; 1 for ())."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major flat index over ``axes`` (mesh order)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group over ``axes`` that holds this rank."""
        return self._groups[self._axes(axes)]

    def _collective(self, fn, x: torch.Tensor, axes) -> torch.Tensor:
        """Run ``fn(buffer, group)`` on a copy of x, staged through host
        memory when gloo meets a CUDA tensor; returns the buffer on x's
        device. Calls and seconds are counted: host seconds for a staged or
        CPU operand (a staged one waits for its stream first, outside the
        count), CUDA events for one that stays on the device."""
        self.collective_calls += 1
        if x.is_cuda and self.backend != "gloo":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = fn(x.detach().clone(), self.group(axes))
            end.record()
            self._events.append((start, end))
            return out
        stage = x.is_cuda
        if stage:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        buf = x.detach().to("cpu", copy=True) if stage else x.detach().clone()
        out = fn(buf, self.group(axes))
        if stage:
            out = out.to(x.device)
            torch.cuda.synchronize(x.device)
        self._host_seconds += time.perf_counter() - t0
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum", axes=()) -> torch.Tensor:
        """A new tensor: x reduced (``"sum"`` or ``"max"``) over ``axes``
        (x itself, copied, when they span one rank)."""
        if self.axis_size(axes) == 1:
            return x.detach().clone()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def run(buf, group):
            dist.all_reduce(buf, op=red, group=group)
            return buf

        return self._collective(run, x, axes)

    def all_gather(self, x: torch.Tensor, axes=(), dim: int = 0) -> torch.Tensor:
        """The ranks' x over ``axes``, concatenated along ``dim`` in the
        order of their flat index."""
        n = self.axis_size(axes)
        if n == 1:
            return x.detach().clone()

        def run(buf, group):
            parts = [torch.empty_like(buf) for _ in range(n)]
            dist.all_gather(parts, buf.contiguous(), group=group)
            return torch.cat(parts, dim=dim)

        return self._collective(run, x, axes)

    def barrier(self) -> None:
        dist.barrier()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend!r}, device={self.device})")


def mesh_by_id(mesh_id: int) -> Mesh:
    """The live mesh of ``mesh_id`` (KeyError once it has been collected)."""
    return _MESHES[mesh_id]


def _unravel(rank: int, shape: tuple) -> tuple:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _blocks(shape: tuple, names: tuple, axes: tuple) -> list:
    """The partition of the ranks into blocks that vary only along
    ``axes``: one block per combination of the other axes' coordinates,
    ranks in row-major order."""
    ranks = list(range(math.prod(shape)))
    other = [i for i, a in enumerate(names) if a not in axes]
    blocks: dict[tuple, list] = {}
    for r in ranks:
        c = _unravel(r, shape)
        blocks.setdefault(tuple(c[i] for i in other), []).append(r)
    return [blocks[k] for k in sorted(blocks)]
