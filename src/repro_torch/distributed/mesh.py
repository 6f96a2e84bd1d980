"""Device meshes over a ``torch.distributed`` group.

A ``Mesh`` is the port's counterpart of ``jax.sharding.Mesh``: named axes
and their sizes over the ranks of an initialised process group, laid out
row-major (rank = ((i0 * s1) + i1) * s2 + ...). It holds this rank's
coordinates, one subgroup per set of axes (created at construction, by
every rank in the same order, so that no rank ever creates a group alone)
and the rank's device, the card unless the caller asks for the CPU.
Collectives go through ``Mesh.all_reduce`` / ``Mesh.all_gather`` /
``Mesh.reduce_scatter`` / ``Mesh.all_to_all`` / ``Mesh.broadcast`` and the
point-to-point ``Mesh.send`` / ``Mesh.recv``, which also count the seconds
spent in them, in all and by operation (``seconds_by_op``), and their
calls and result bytes by operation and group size (``traffic``,
``bytes_by_op``).

A mesh may span some of the world's ranks (``ranks=``, laid out row-major
over that list: an elastic restart's survivors). Every world rank
constructs it, since ``dist.new_group`` is collective over the world; a
rank outside it gets a mesh with ``member`` false, whose collectives
raise. ``rank`` is the rank's flat index in the mesh, ``world_rank`` its
rank in the process group. ``AbstractMesh`` is a mesh with no process
group (the dry-run's production meshes): the same axis API for the rank
it stands for, collectives that record (op, axes, group size, result
bytes) and return meta tensors.

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

``Mesh.reduce_scatter`` is an all-reduce followed by the rank's slice:
gloo has no reduce-scatter of its own. It moves the whole tensor where a
ring reduce-scatter would move 1 / n of it a rank, and costs what an
all-reduce of the tensor does; it is counted as that all-reduce.

Region ops. Parameter sharding (``distributed/sharding.py:param_layout``)
runs through four autograd-aware custom ops (torch transposes no
collective, so each names its backward), which find their mesh by
``mesh_id`` and take the axes comma-joined (on an ``AbstractMesh`` their
fake implementations run the collective, which records it):

* ``repro_torch::tp_copy``: identity forward, all-reduce backward (where a
  replicated activation enters tensor-parallel work: each rank's cotangent
  is its share);
* ``repro_torch::tp_reduce``: all-reduce forward, identity backward (a
  row-parallel product's partial sums; the vocab-parallel lookup and the
  sum-exp and gold logit of the vocab-parallel cross entropy);
* ``repro_torch::fsdp_gather``: a list of slices all-gathered along their
  dims as one flat buffer forward, the cotangents summed and sliced back
  (``reduce_scatter``) backward;
* ``repro_torch::ep_all_to_all``: the expert-parallel exchange
  (``models/moe.py:moe_forward_ep``), an all-to-all along dim 0 forward
  and the inverse exchange, the same all-to-all, backward;
* the vocab-parallel pieces are the masked lookup (``models/model.py``;
  ``vocab_shard_index`` places an id in a rank's shard, for it and the
  cross entropy's gold logit) and the cross entropy's max (``Mesh.all_reduce(..., "max")`` of a
  detached tensor, ``train/losses.py``) around ``tp_reduce``.

The launch layer (``launch/mesh.py``) builds meshes and spawns local ranks;
the custom ops here and those of the context-parallel attention
(``kernels/sharded.py``), which cannot take a process group as an argument,
find a mesh by ``mesh_id``.
"""
from __future__ import annotations

import datetime
import itertools
import math
import time
import weakref
from typing import Optional, Sequence

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
                 ranks: Optional[Sequence[int]] = None, device="cuda",
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if not dist.is_initialized():
            raise RuntimeError("Mesh: initialise torch.distributed first "
                               "(init_process_group, or launch.mesh.spawn_local)")
        world = dist.get_world_size()
        ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
        if len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
            raise ValueError(f"Mesh: ranks {ranks} are not distinct ranks of a world "
                             f"of {world}")
        shape, axis_names = self._setup(shape, axis_names, len(ranks), "the rank list")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Mesh: device 'cuda' requested but no GPU is "
                                   "available; pass device='cpu'")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.ranks = tuple(ranks)
        self.world_rank = dist.get_rank()
        self.member = self.world_rank in self.ranks
        self.rank = self.ranks.index(self.world_rank) if self.member else None
        self.coords = dict(zip(axis_names, _unravel(self.rank, shape))) if self.member else {}
        self.backend = dist.get_backend()
        self.timeout_s = timeout_s
        timeout = datetime.timedelta(seconds=timeout_s)
        self._owned: list = []           # the subgroups this mesh created and holds
        # every non-empty set of axes, in one order on every rank: new_group
        # is collective over the whole world, for every block
        for size in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, size):
                if len(axes) == len(axis_names) and len(ranks) == world:
                    self._groups[axes] = dist.group.WORLD
                    continue
                mine = None
                for block in _blocks(shape, axis_names, axes):
                    g = dist.new_group([self.ranks[i] for i in block], timeout=timeout)
                    if self.member and self.rank in block:
                        mine = g
                        self._owned.append(g)
                self._groups[axes] = mine
        _MESHES[self.mesh_id] = self

    def _setup(self, shape, axis_names, n: int, what: str) -> tuple:
        """Check the shape against ``n`` ranks and set the axis fields and
        the counters; returns (shape, axis_names) as tuples."""
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"Mesh: shape {shape} and axis names {axis_names} disagree")
        if math.prod(shape) != n:
            raise ValueError(f"Mesh: shape {shape} has {math.prod(shape)} ranks, {what} "
                             f"{n}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self._host_seconds = 0.0
        self._by_op: dict[str, float] = {}
        self._traffic: dict[tuple, list] = {}   # (op, group size) -> [calls, result bytes]
        self._events: list = []          # (op, start, end) CUDA events of unstaged collectives
        self.collective_calls = 0
        self._groups: dict[tuple, object] = {}
        self.mesh_id = id(self)
        return shape, axis_names

    def close(self) -> None:
        """Destroy the subgroups this mesh created that hold this rank (a
        mesh left behind by an elastic restart, once every rank is past
        it); the mesh is unusable after."""
        for g in self._owned:
            dist.destroy_process_group(g)
        self._owned.clear()
        self._groups.clear()

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def collective_seconds(self) -> float:
        """Seconds spent in this mesh's collectives so far (reading it waits
        for the device collectives it has not timed yet)."""
        self._read_events()
        return self._host_seconds

    def seconds_by_op(self) -> dict:
        """``collective_seconds`` split by operation ("all_reduce",
        "all_gather", "all_to_all", "broadcast", "send", "recv")."""
        self._read_events()
        return dict(self._by_op)

    def _read_events(self) -> None:
        """Count the device collectives timed by CUDA events so far."""
        for op, start, end in self._events:
            end.synchronize()
            self._count(op, start.elapsed_time(end) / 1e3)
        self._events.clear()

    def traffic(self) -> dict:
        """{(op, group size): (calls, result bytes)} of this mesh's
        collectives so far: the bytes of each call's result on this rank
        (an all-gather's whole output; a ``reduce_scatter`` is the
        all-reduce of the whole tensor it runs, what goes on the wire)."""
        return {k: tuple(v) for k, v in self._traffic.items()}

    def bytes_by_op(self) -> dict:
        """Result bytes of this mesh's collectives so far, by operation."""
        out: dict[str, int] = {}
        for (op, _), (_, nbytes) in self._traffic.items():
            out[op] = out.get(op, 0) + nbytes
        return out

    def _count_traffic(self, op: str, group: int, shape, x: torch.Tensor) -> None:
        rec = self._traffic.setdefault((op, group), [0, 0])
        rec[0] += 1
        rec[1] += math.prod(shape) * x.element_size()

    def _count(self, op: str, seconds: float) -> None:
        self._host_seconds += seconds
        self._by_op[op] = self._by_op.get(op, 0.0) + seconds

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"Mesh: unknown axes {unknown}; the mesh has {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        """Ranks spanned by ``axes`` (a name or a tuple; 1 for ())."""
        return math.prod(self.shape[a] for a in self._axes(axes))

    def _require_member(self) -> None:
        if not self.member:
            raise RuntimeError(f"Mesh: world rank {self.world_rank} is outside this mesh "
                               f"(ranks {list(self.ranks)})")

    def index(self, axes) -> int:
        """This rank's row-major flat index over ``axes`` (mesh order)."""
        self._require_member()
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group over ``axes`` that holds this rank."""
        self._require_member()
        return self._groups[self._axes(axes)]

    def _collective(self, fn, x: torch.Tensor, axes, op: str,
                    out_shape=None) -> torch.Tensor:
        """Run ``fn(buffer, group)`` on a copy of x, staged through host
        memory when gloo meets a CUDA tensor; returns the buffer on x's
        device. Calls and seconds are counted under ``op``: host seconds
        for a staged or CPU operand (a staged one waits for its stream
        first, outside the count), CUDA events for one that stays on the
        device; calls and result bytes (``out_shape``: the result's shape,
        x's by default) by op and group size."""
        self._require_member()
        self.collective_calls += 1
        self._count_traffic(op, self.axis_size(axes), x.shape if out_shape is None
                            else out_shape, x)
        if x.is_cuda and self.backend != "gloo":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = fn(x.detach().clone(), self.group(axes))
            end.record()
            self._events.append((op, start, end))
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
        self._count(op, time.perf_counter() - t0)
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

        return self._collective(run, x, axes, "all_reduce")

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

        shape = list(x.shape)
        shape[dim] *= n
        return self._collective(run, x, axes, "all_gather", shape)

    def reduce_scatter(self, x: torch.Tensor, axes=(), dim: int = 0) -> torch.Tensor:
        """The sum of x over ``axes``, split along ``dim`` into as many
        equal parts as the axes span ranks: this rank's part (its flat
        index), an all-reduce and a slice."""
        n = self.axis_size(axes)
        out = self.all_reduce(x, "sum", axes)
        return out if n == 1 else out.chunk(n, dim)[self.index(axes)].contiguous()

    def all_to_all(self, x: torch.Tensor, axes=()) -> torch.Tensor:
        """x's dim 0 cut into as many equal parts as ``axes`` span ranks,
        part i sent to the rank of flat index i; returns the parts received,
        stacked along dim 0 in the senders' flat-index order (the tiled
        ``jax.lax.all_to_all`` with split and concat axis 0). Its own
        inverse."""
        n = self.axis_size(axes)
        if x.shape[0] % n:
            raise ValueError(f"Mesh.all_to_all: dim 0 of {tuple(x.shape)} does not split "
                             f"into {n} parts")
        if n == 1:
            return x.detach().clone()

        def run(buf, group):
            buf = buf.contiguous()
            out = torch.empty_like(buf)
            dist.all_to_all_single(out, buf, group=group)
            return out

        return self._collective(run, x, axes, "all_to_all")

    def peer(self, axes, index: int) -> int:
        """The world rank at flat index ``index`` over ``axes`` that shares
        this rank's coordinates on every other axis."""
        self._require_member()
        axes = self._axes(axes)
        coords = dict(self.coords)
        for a, c in zip(axes, _unravel(index, tuple(self.shape[a] for a in axes))):
            coords[a] = c
        rank = 0
        for a in self.axis_names:
            rank = rank * self.shape[a] + coords[a]
        return self.ranks[rank]

    def broadcast(self, x: torch.Tensor, axes, src: int) -> torch.Tensor:
        """The tensor of the rank at flat index ``src`` over ``axes``, on
        every rank of them (x: this rank's, of the same shape and dtype)."""
        if self.axis_size(axes) == 1:
            return x.detach().clone()

        def run(buf, group):
            dist.broadcast(buf, src=self.peer(axes, src), group=group)
            return buf

        return self._collective(run, x, axes, "broadcast")

    def send(self, x: torch.Tensor, axes, dst: int) -> None:
        """Send x to the rank at flat index ``dst`` over ``axes`` (blocks
        until the transfer is done)."""
        def run(buf, group):
            dist.send(buf.contiguous(), dst=self.peer(axes, dst), group=group)
            return buf

        self._collective(run, x, axes, "send")

    def recv(self, like: torch.Tensor, axes, src: int) -> torch.Tensor:
        """A tensor of ``like``'s shape, dtype and device received from the
        rank at flat index ``src`` over ``axes``."""
        def run(buf, group):
            dist.recv(buf, src=self.peer(axes, src), group=group)
            return buf

        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        return self._collective(run, buf, axes, "recv")

    def barrier(self) -> None:
        """Wait for every rank of the mesh (its all-axes group)."""
        dist.barrier(group=self.group(self.axis_names))

    def __repr__(self) -> str:
        where = f"rank={self.rank}" if self.member else f"outside (world rank {self.world_rank})"
        return (f"{type(self).__name__}({self.shape}, {where}, coords={self.coords}, "
                f"backend={self.backend!r}, device={self.device})")


class AbstractMesh(Mesh):
    """A mesh with no process group: the dry-run's production meshes
    (``launch/mesh.py:make_production_mesh``). It has ``Mesh``'s axis API
    for the rank it stands for (``rank``, flat index, 0 by default), lives
    on the ``meta`` device and is registered by ``mesh_id``, so the region
    ops and the context-parallel attention find it. Its collectives
    allocate nothing: each records (op, axes, group size, result bytes) in
    ``records``, counts ``traffic`` as a real mesh does, and returns a meta
    tensor of the result's shape."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *, rank: int = 0):
        shape, axis_names = self._setup(shape, axis_names, math.prod(shape), "the shape")
        if not 0 <= rank < math.prod(shape):
            raise ValueError(f"AbstractMesh: rank {rank} outside {math.prod(shape)} ranks")
        self.device = torch.device("meta")
        self.ranks = tuple(range(math.prod(shape)))
        self.world_rank = self.rank = rank
        self.member = True
        self.coords = dict(zip(axis_names, _unravel(rank, shape)))
        self.backend = "abstract"
        self._owned = []
        self.records: list[tuple] = []
        _MESHES[self.mesh_id] = self

    def group(self, axes):
        raise RuntimeError("AbstractMesh: no process group")

    def _collective(self, fn, x, axes, op, out_shape=None):
        shape = tuple(x.shape if out_shape is None else out_shape)
        n = self.axis_size(axes)
        self.collective_calls += 1
        self._count_traffic(op, n, shape, x)
        self.records.append((op, self._axes(axes), n, math.prod(shape) * x.element_size()))
        return torch.empty(shape, dtype=x.dtype, device="meta")

    def barrier(self) -> None:
        pass


def mesh_by_id(mesh_id: int) -> Mesh:
    """The live mesh of ``mesh_id`` (KeyError once it has been collected)."""
    return _MESHES[mesh_id]


def abstract_mesh(mesh_id: int) -> Optional[AbstractMesh]:
    """The mesh of ``mesh_id`` if it is an ``AbstractMesh``, else None. A
    custom op's fake (meta) implementation runs the op's collectives there,
    so the dry-run records them."""
    mesh = _MESHES.get(mesh_id)
    return mesh if isinstance(mesh, AbstractMesh) else None


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


# --------------------------------------------------------------------------
# Region ops of parameter sharding.
# --------------------------------------------------------------------------
def _split_axes(axes: str) -> tuple:
    return tuple(a for a in axes.split(",") if a)


@torch.library.custom_op("repro_torch::tp_copy", mutates_args=())
def tp_copy(x: torch.Tensor, mesh_id: int, axes: str) -> torch.Tensor:
    """x itself (a copy) forward; the cotangent summed over ``axes``
    backward."""
    return x.clone()


@tp_copy.register_fake
def _(x, mesh_id, axes):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::tp_reduce", mutates_args=())
def tp_reduce(x: torch.Tensor, mesh_id: int, axes: str) -> torch.Tensor:
    """x summed over ``axes`` forward, in x's dtype (over 2 ranks a bf16
    sum rounds once, as an fp32 sum rounded to bf16 does; over more, once
    an addition); the cotangent as it is backward."""
    return mesh_by_id(mesh_id).all_reduce(x, "sum", _split_axes(axes))


@tp_reduce.register_fake
def _(x, mesh_id, axes):
    mesh = abstract_mesh(mesh_id)
    return (mesh.all_reduce(x, "sum", _split_axes(axes)) if mesh is not None
            else torch.empty_like(x))


def _meta_setup(ctx, inputs, output):
    ctx.meta = inputs[1:]


tp_copy.register_autograd(
    lambda ctx, g: (tp_reduce(g.contiguous(), *ctx.meta), None, None),
    setup_context=_meta_setup)
tp_reduce.register_autograd(
    lambda ctx, g: (tp_copy(g.contiguous(), *ctx.meta), None, None),
    setup_context=_meta_setup)


@torch.library.custom_op("repro_torch::fsdp_gather", mutates_args=())
def fsdp_gather(xs: list[torch.Tensor], dims: list[int], mesh_id: int,
                axes: str) -> list[torch.Tensor]:
    """Each slice of ``xs`` all-gathered over ``axes`` along its dim of
    ``dims`` (ranks in flat-index order), as one flat buffer of their common
    dtype in one collective."""
    return _fsdp_gather(xs, dims, mesh_id, axes)


def _fsdp_gather(xs, dims, mesh_id, axes):
    mesh, ax = mesh_by_id(mesh_id), _split_axes(axes)
    n = mesh.axis_size(ax)
    flat = torch.cat([x.reshape(-1) for x in xs])
    rows = mesh.all_gather(flat, ax).view(n, -1)
    out, off = [], 0
    for x, d in zip(xs, dims):
        parts = rows[:, off:off + x.numel()]
        out.append(torch.cat([p.view(x.shape) for p in parts], dim=d))
        off += x.numel()
    return out


@fsdp_gather.register_fake
def _(xs, dims, mesh_id, axes):
    if abstract_mesh(mesh_id) is not None:
        return _fsdp_gather(xs, dims, mesh_id, axes)
    n = 1
    for a in _split_axes(axes):
        n *= mesh_by_id(mesh_id).shape[a]
    out = []
    for x, d in zip(xs, dims):
        shape = list(x.shape)
        shape[d] *= n
        out.append(x.new_empty(shape))
    return out


def _fsdp_gather_setup(ctx, inputs, output):
    ctx.dims, ctx.mesh_id, ctx.axes = inputs[1:]
    ctx.shapes = [x.shape for x in inputs[0]]
    ctx.dtypes = [x.dtype for x in inputs[0]]


def _fsdp_gather_backward(ctx, grads):
    """The cotangents summed over the axes (fp32) and cut back to this
    rank's slices: row r of the flat buffer holds every leaf's part r."""
    mesh, ax = mesh_by_id(ctx.mesh_id), _split_axes(ctx.axes)
    n = mesh.axis_size(ax)
    grads = [torch.zeros(s[:d] + (s[d] * n,) + s[d + 1:], dtype=torch.float32,
                         device=mesh.device) if g is None else g.float()
             for g, s, d in zip(grads, ctx.shapes, ctx.dims)]
    rows = torch.stack([torch.cat([g.chunk(n, d)[r].reshape(-1)
                                   for g, d in zip(grads, ctx.dims)]) for r in range(n)])
    mine = mesh.reduce_scatter(rows, ax, dim=0)[0]
    out, off = [], 0
    for s, dt in zip(ctx.shapes, ctx.dtypes):
        numel = math.prod(s)
        out.append(mine[off:off + numel].view(s).to(dt))
        off += numel
    return out, None, None, None


fsdp_gather.register_autograd(_fsdp_gather_backward, setup_context=_fsdp_gather_setup)


@torch.library.custom_op("repro_torch::ep_all_to_all", mutates_args=())
def ep_all_to_all(x: torch.Tensor, mesh_id: int, axes: str) -> torch.Tensor:
    """``Mesh.all_to_all`` of x over ``axes`` (dim 0 split, one part to
    each rank); its backward is the inverse exchange of the cotangent,
    the same all-to-all."""
    return mesh_by_id(mesh_id).all_to_all(x, _split_axes(axes))


@ep_all_to_all.register_fake
def _(x, mesh_id, axes):
    mesh = abstract_mesh(mesh_id)
    return mesh.all_to_all(x, _split_axes(axes)) if mesh is not None else torch.empty_like(x)


ep_all_to_all.register_autograd(
    lambda ctx, g: (ep_all_to_all(g.contiguous(), *ctx.meta), None, None),
    setup_context=_meta_setup)


def vocab_shard_index(ids: torch.Tensor, mesh: Mesh, axes: tuple, size: int):
    """(index, mine) of vocab ids in this rank's shard of a vocab split
    over ``axes`` in ``size`` rows a rank (rank i holds rows i * size..):
    ``mine`` marks the ids the rank holds, ``index`` is their row in the
    shard, 0 for the rest (a valid row, to be zeroed by ``mine``)."""
    local = ids - mesh.index(axes) * size
    mine = (local >= 0) & (local < size)
    return torch.where(mine, local, 0), mine
