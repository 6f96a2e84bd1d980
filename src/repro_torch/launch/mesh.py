"""Production and local meshes, and local ranks (``repro/launch/mesh.py``).

``make_production_mesh`` is the reference's 16 x 16 ("data", "model")
mesh, or 2 x 16 x 16 ("pod", "data", "model") with ``multi_pod``, as an
``AbstractMesh``: no process group, one rank's view (rank 0 unless
asked), collectives recorded on the meta device, which is what the
dry-run (``launch/dryrun.py``) traces a step on. ``make_local_mesh`` is
the reference's (world // model_parallel, model_parallel) mesh over every
rank of an initialised process group; the ``Mesh`` itself (named axes,
subgroups, the rank's device, counted collectives, the backends' rules)
lives in ``distributed/mesh.py``.

``spawn_local`` runs a function on N local ranks (``spawn`` start method,
since the parent may already hold a CUDA context), each with a process
group whose every collective times out after ``timeout_s``, so a hung rank
fails its run instead of hanging it. Ranks run on the card (GPU rank mod
the GPU count) unless the caller asks for ``device="cpu"``; the backend
is an explicit argument: ``"gloo"`` on the CPU and for ranks that share a
card, ``"nccl"`` for ranks that each own one. A rank whose function has
returned waits for the others before its process group goes away (rank 0
hosts the group's store; an elastic restart leaves ranks idle early).
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import DEFAULT_TIMEOUT_S, AbstractMesh, Mesh


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> AbstractMesh:
    """16 x 16 single-pod (256 chips) or 2 x 16 x 16 multi-pod (512 chips)
    (``repro/launch/mesh.py:11``), seen from ``rank``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes, rank=rank)


def make_local_mesh(model_parallel: int = 1, axis_names=("data", "model"), *,
                    device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """(world // model_parallel, model_parallel) over every rank of the
    initialised group (``repro/launch/mesh.py:18``), on ``device`` (the
    card unless the caller asks for "cpu")."""
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"make_local_mesh: {n} ranks do not split into model "
                         f"axes of {model_parallel}")
    return Mesh((n // model_parallel, model_parallel), axis_names, device=device,
                timeout_s=timeout_s)


def rank_device(rank: int, device: str) -> torch.device:
    """The device of local rank ``rank``: the CPU, or GPU rank mod the GPU
    count (ranks share a card when there are more ranks than cards)."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank device was asked for and none is present")
    return torch.device("cuda", rank % torch.cuda.device_count())


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, nproc, port, backend, timeout_s, threads, device, mesh_shape,
               axis_names, fn, args, results):
    try:
        if backend == "gloo":
            # local ranks talk over the loopback device, whatever the host's
            # name resolves to (a machine without a network may resolve none)
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(threads)
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=nproc, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = Mesh(mesh_shape, axis_names, device=dev, timeout_s=timeout_s)
            value = fn(mesh, *args)
            dist.barrier()   # rank 0 hosts the store: the group outlives every rank's work
            results.put((rank, value, None))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises with it
        results.put((rank, None, traceback.format_exc()))


def spawn_local(fn: Callable, mesh_shape: Sequence[int],
                axis_names: Sequence[str] = ("data", "model"), *, args: tuple = (),
                backend: str = "gloo", device: str = "cuda",
                timeout_s: float = DEFAULT_TIMEOUT_S, threads: int = 1) -> list:
    """Run ``fn(mesh, *args)`` on prod(mesh_shape) local ranks, each a
    process started with the ``spawn`` method, with its process group
    (``backend``, on ``tcp://localhost`` at a free port; every collective
    times out after ``timeout_s``) and its ``Mesh`` (``device`` "cuda",
    where rank r takes GPU r mod the GPU count and no GPU raises here, or
    "cpu"). ``fn`` must be a
    module-level function and return something picklable (host values:
    move tensors to numpy). Returns the ranks' results in rank order.
    Raises with the failing rank's traceback if any rank fails, and
    ``TimeoutError`` if the ranks have not all returned within
    ``timeout_s`` plus start-up; every process is ended either way."""
    rank_device(0, device)   # no GPU for a "cuda" run raises before any spawn
    nproc = math.prod(mesh_shape)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nproc, port, backend, timeout_s, threads, device,
                               tuple(mesh_shape), tuple(axis_names), fn, args, results))
             for r in range(nproc)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s + 120.0
    try:
        while len(out) < nproc:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn_local: ranks {sorted(set(range(nproc)) - set(out))} "
                                   f"did not return within {timeout_s + 120.0:.0f} s")
            try:
                rank, value, err = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(f"spawn_local: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before returning")
                continue
            if err is not None:
                raise RuntimeError(f"spawn_local: rank {rank} failed:\n{err}")
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    return [out[r] for r in range(nproc)]
