"""Impl / tiling dispatch for spectral-shifting attention
(``repro/kernels/dispatch.py``).

One registry answers "which implementation, which tiling?" for every
attention call:

    key  = (backend, n_bucket, c, d, dtype, causal, family, seq_shards)
    plan = Plan(impl = fused | jnp | interpret | sharded | paged, block_n,
                block_c, block_table, source)

``backend`` is the tensor's device type, ``"cuda"`` or ``"cpu"``; a cache
file written by the JAX package carries ``"cpu"`` / ``"tpu"`` keys and
never matches a ``"cuda"`` one. ``family="decode"`` keys serving's
one-step shape (n = cache horizon).

Resolution order, as the reference's: in-memory registry -> on-disk cache
-> measured autotune (only when enabled) -> backend heuristic. The JSON
cache (``REPRO_AUTOTUNE_CACHE`` or ``~/.cache/repro/ss_autotune.json``,
moved by ``set_cache_path``) is written at version 3; versions 1-3 load,
missing fields defaulting to 0.

What a plan means on CUDA:

* ``block_n`` (self family) is the key / query tiling the reference's
  block size sets: K1 / K3's ``chunk_keys`` (a whole number of
  ``KEY_TILE`` keys) and K2 / K4's ``run_rows`` (a whole number of
  ``QUERY_TILE`` rows; K4 takes whole ``QS_BWD_STEP_ROWS``). The fp32 FMA
  kernels of K1-K3 do not tile keys or query runs and ignore it; the
  plain versions on the CPU ignore every tiling. For a decode key
  ``block_n`` is K5's ``chunk_slots`` (whole steps of whole blocks).
* ``block_c`` (self family) is the landmark rows a CTA of K1 / K3's bf16
  kernels walks (their ``row_block``): 0 is the kernels' own plan (one
  ``ROW_TILE`` of 64 rows a CTA, every row tile on the grid), otherwise a
  multiple of ``ROW_TILE`` that divides c (the CTA walks its row tiles in
  order over its key chunk). The reference's ``block_c`` tiles the rows
  over a grid axis at any divisor; a value the kernels cannot take, such
  as the reference's c / 4 = 32 at c = 128 (below wgmma's M), is refused
  by ``check_tiling`` before any launch and left out of a sweep. K2 / K4
  and the fp32 kernels do not tile landmark rows and ignore it.
* ``block_table`` is the view quantum ``serve/paged.py:view_blocks_needed``
  takes: the paged decode tick slices each lane's table to a multiple of
  it.

The one named difference from the reference: its heuristics pick block
sizes 256 / 512 / 1024 by n; here the heuristic's tiling is the sentinel
0, "the kernel's own plan" (``chunk_plan``, ``query_tile_plan``,
``query_side_bwd_plan``, ``slot_chunk_plan``, and the whole table for the
paged tick), so that without a measured or registered plan nothing moves.
The self family's CPU heuristic is ``"fused"`` (the kernels' plain
versions, the route the port's CPU runs have always taken) where the
reference's is ``"jnp"`` (interpret-mode Pallas is slow there); the
decode family keeps the reference's ``"jnp"`` on the CPU, which steers no
route.

A plan for a ``"cuda"`` key always names a kernel route: the sweeps time
only kernel candidates there, and ``get_plan`` raises for a registered or
cached plan that would put plain PyTorch on the card (``"jnp"``,
``"interpret"``); only ``backend="jnp"`` asks for that route, by name.

The measured sweep runs on synthetic data of the key's shape (at a
caller-given batch, so the split-key grid is sized as it will run). On the
card it times each tiling the kernels take (the heuristic's 0 among them)
on the launches that tiling reaches: K1 and K2, and for a training key
(``backward=True``: the trainer's warm-up, or an autotuned call that needs
a gradient) K3 and K4 too; for a decode key, K5 at each view quantum and
slot chunk. A candidate the kernels cannot take is left out by a shape
check before timing, and a launch error raises. Every kernel is built
before the first timed candidate; each candidate runs once untimed, then
the best of ``reps`` timings of ``iters`` back-to-back passes counts, read
by CUDA events behind a device-side hold, so host gaps between launches
stay out. On the CPU the jnp (gather) route is timed against the plain
versions by the wall clock. Kernel launches made by a sweep are counted
apart (``SWEEP_LAUNCHES``), not in the wrappers' ``launches``. A key's
plan serves every call of that key, so a forward-only sweep's tiling would
reach K3 / K4 untimed if the same key later trained; the serving prefill
key is bidirectional and a decoder's train key causal, so for the
configs here the two never meet.

``autotune_plan_resolutions_total`` counts every ``get_plan`` call: an
eager attention site resolves at each call, where the reference's jitted
step resolves once per trace, so over training steps the port's "memory"
count grows with the calls.

Context parallelism. Inside ``distributed.sharding.sharding_rules`` with
the sequence split over more than one rank, a self-attention site keys
``seq_shards`` (and the GLOBAL n, the rank's rows times the shards) and
every kernel route ("fused", "interpret", "sharded") runs the
context-parallel attention (``kernels/sharded.py``) on the rank's rows. The
heuristic for such a key is "sharded" at the kernels' own tiling (0);
``get_plan`` never sweeps one (the single-rank sweep cannot reproduce the
multi-rank program), as the reference. A plain-torch route ("jnp") or a
cross-attention shape under a sequence shard raises: a rank holds only its
own rows, and nothing gathers the rest for them.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import math
import os
import threading
import time
import weakref
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.core.attention import SSConfig, spectral_shift_attention
from repro_torch.telemetry.metrics import NullRegistry

_IMPLS = ("fused", "jnp", "interpret", "sharded", "paged")
_FAMILIES = ("self", "decode")

# Telemetry sink: the no-op registry until ServeEngine / Trainer install
# theirs with set_metrics() (process-wide, like the plan registry). Held
# weakly: a registry's fn-gauges reach back to the engine that owns it, so
# a strong hold here would keep a dropped engine (and its pools) alive.
_NULL = NullRegistry()
_metrics_ref = None

# Kernel launches made by measured sweeps, by wrapper name, and each
# sweep's candidates with their seconds, by key.
SWEEP_LAUNCHES: dict[str, int] = {}
SWEEPS: dict[str, list] = {}
# Device cycles a timing holds the stream for while the host enqueues the
# calls it times (about 10 ms at the H100's 1.98 GHz).
_HOLD_CYCLES = 20_000_000


def set_metrics(registry) -> None:
    """Install a metrics registry (held weakly) for the plan-resolution
    counters. ``None`` or ``NullRegistry()`` detaches."""
    global _metrics_ref
    _metrics_ref = weakref.ref(registry) if registry is not None else None


def _metrics():
    registry = _metrics_ref() if _metrics_ref is not None else None
    return registry if registry is not None else _NULL


def _count_resolution(outcome: str) -> None:
    # outcome: memory | disk | miss_sweep | miss_heuristic
    _metrics().counter(
        "autotune_plan_resolutions_total",
        help="get_plan outcomes by resolution tier",
        labels=("outcome",),
    ).labels(outcome=outcome).inc()


def _count_sweep(family: str) -> None:
    _metrics().counter(
        "autotune_sweeps_total", help="measured autotune sweeps run",
        labels=("family",),
    ).labels(family=family).inc()


@dataclasses.dataclass(frozen=True)
class PlanKey:
    backend: str      # "cpu" | "cuda" (the reference's also "tpu" | "gpu")
    n: int            # sequence length, bucketed to the next power of two
    c: int            # landmark count
    d: int            # head dim
    dtype: str        # "float32" / "bfloat16"
    causal: bool
    family: str = "self"   # "self" | "decode" (one step against n keys)
    seq_shards: int = 1    # devices the sequence axis spans

    def encode(self) -> str:
        kind = "causal" if self.causal else "bidir"
        s = f"{self.backend}|n{self.n}|c{self.c}|d{self.d}|{self.dtype}|{kind}"
        if self.family != "self":
            s += f"|{self.family}"
        if self.seq_shards > 1:
            s += f"|sp{self.seq_shards}"
        return s

    @staticmethod
    def decode(s: str) -> "PlanKey":
        parts = s.split("|")
        backend, n, c, d, dtype, kind = parts[:6]
        family, seq_shards = "self", 1
        for extra in parts[6:]:
            if extra.startswith("sp"):
                seq_shards = int(extra[2:])
            elif extra in _FAMILIES:
                family = extra
            else:
                raise ValueError(f"unknown PlanKey suffix {extra!r}")
        return PlanKey(backend=backend, n=int(n[1:]), c=int(c[1:]), d=int(d[1:]),
                       dtype=dtype, causal=(kind == "causal"), family=family,
                       seq_shards=seq_shards)


@dataclasses.dataclass(frozen=True)
class Plan:
    impl: str             # "fused" | "jnp" | "interpret" | "sharded" | "paged"
    block_n: int = 512    # tiling; 0 = the kernel's own plan (see above)
    block_c: int = 0      # K1 / K3 landmark rows a CTA walks (0 = their own plan)
    block_table: int = 0  # decode family: the view quantum (0 = whole table)
    source: str = "heuristic"  # heuristic | registered | cache | autotuned

    def __post_init__(self):
        if self.impl not in _IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; want one of {_IMPLS}")


@dataclasses.dataclass(frozen=True)
class Tiling:
    """The serving tiling in effect (``use_tiling``): K1 / K2's key chunk
    and query run (a prefill plan's ``block_n``) and K5's slot chunk (a
    decode plan's ``block_n``); 0 = the kernel's own plan."""
    block_n: int = 0
    chunk_slots: int = 0


_TILING: contextvars.ContextVar = contextvars.ContextVar("repro_torch_tiling",
                                                         default=Tiling())


@contextlib.contextmanager
def use_tiling(block_n: int = 0, chunk_slots: int = 0):
    """Run the calls inside at resolved plans' tilings: a K1 or K2 launch
    given no tiling of its own takes ``block_n``, a K5 launch
    ``chunk_slots``. The serving engine enters it around each tick with its
    prefill and decode plans, so no layer function carries a tiling."""
    token = _TILING.set(Tiling(int(block_n), int(chunk_slots)))
    try:
        yield
    finally:
        _TILING.reset(token)


def current_tiling() -> Tiling:
    return _TILING.get()


_lock = threading.Lock()
_REGISTRY: dict[PlanKey, Plan] = {}
_CACHE_LOADED: set[str] = set()
_CACHE_OVERRIDE: Optional[str] = None


def _bucket(n: int) -> int:
    """Next power of two >= n (min 128): nearby lengths share one plan."""
    b = 128
    while b < n:
        b *= 2
    return b


def dtype_name(dtype) -> str:
    """Canonical dtype name of a torch dtype or a name ("bfloat16")."""
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else str(dtype)


def default_backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_key(n: int, c: int, d: int, dtype, causal: bool,
             backend: Optional[str] = None, family: str = "self",
             seq_shards: int = 1) -> PlanKey:
    """The key of an attention call of n tokens (``family="decode"``: one
    query against a cache horizon of n); ``seq_shards`` keys
    context-parallel cells by the ranks the sequence axis spans."""
    if family not in _FAMILIES:
        raise ValueError(f"unknown key family {family!r}; want one of {_FAMILIES}")
    return PlanKey(backend=backend or default_backend(), n=_bucket(n), c=c, d=d,
                   dtype=dtype_name(dtype), causal=causal, family=family,
                   seq_shards=max(int(seq_shards), 1))


def cache_path() -> str:
    if _CACHE_OVERRIDE:
        return _CACHE_OVERRIDE
    return os.environ.get(
        "REPRO_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro", "ss_autotune.json"))


def set_cache_path(path: Optional[str]) -> None:
    """Process-wide cache-file override (``ModelConfig.autotune_cache``);
    ``None`` / "" restores the variable / default."""
    global _CACHE_OVERRIDE
    _CACHE_OVERRIDE = path or None


def register_plan(key: PlanKey, plan: Plan) -> None:
    with _lock:
        _REGISTRY[key] = plan


def clear_registry() -> None:
    global _CACHE_OVERRIDE
    with _lock:
        _REGISTRY.clear()
        _CACHE_LOADED.clear()
        _CACHE_OVERRIDE = None


def load_cache(path: Optional[str] = None) -> int:
    """Merge the on-disk cache's plans into the registry (plans already in
    it win); returns how many entries parsed."""
    path = path or cache_path()
    if not os.path.exists(path):
        return 0
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return 0
    loaded = 0
    with _lock:
        for ks, pd in payload.get("plans", {}).items():
            try:
                key = PlanKey.decode(ks)
                plan = Plan(impl=pd["impl"], block_n=int(pd["block_n"]),
                            block_c=int(pd.get("block_c", 0)),
                            block_table=int(pd.get("block_table", 0)),
                            source="cache")
            except (ValueError, KeyError):
                continue
            _REGISTRY.setdefault(key, plan)
            loaded += 1
        _CACHE_LOADED.add(path)
    return loaded


def save_cache(path: Optional[str] = None) -> str:
    """Write every non-heuristic plan to disk at version 3, merged into the
    file's existing entries, atomically."""
    path = path or cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    existing: dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                existing = json.load(f).get("plans", {})
        except (OSError, json.JSONDecodeError):
            existing = {}
    with _lock:
        for key, plan in _REGISTRY.items():
            if plan.source == "heuristic":
                continue
            existing[key.encode()] = {"impl": plan.impl, "block_n": plan.block_n,
                                      "block_c": plan.block_c,
                                      "block_table": plan.block_table}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"version": 3, "plans": existing}, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def heuristic_plan(key: PlanKey) -> Plan:
    """Backend defaults when nothing measured is available: the kernels'
    own tiling (0) on every backend; see the module docstring."""
    if key.family == "decode":
        if key.backend == "cpu":
            return Plan(impl="jnp", block_n=min(512, key.n), source="heuristic")
        return Plan(impl="paged", block_n=0, source="heuristic")
    impl = "sharded" if key.seq_shards > 1 else "fused"
    return Plan(impl=impl, block_n=0, source="heuristic")


_KERNEL_IMPLS = {"self": ("fused", "sharded"), "decode": ("paged",)}


def _checked(key: PlanKey, plan: Plan) -> Plan:
    """A plan for a "cuda" key names a kernel route ("fused" / "sharded"
    for the self family, "paged" for decode): a plan never puts plain
    PyTorch on the card, which only ``backend="jnp"`` asks for by name.
    ValueError for any other, a registered or cached one included."""
    if key.backend == "cuda" and plan.impl not in _KERNEL_IMPLS[key.family]:
        raise ValueError(
            f"plan {plan.impl!r} ({plan.source}) for {key.encode()}: a CUDA key's "
            f"plan runs the kernels ({' / '.join(_KERNEL_IMPLS[key.family])}); ask "
            f"for the plain route with attention_backend='jnp' instead")
    return plan


def get_plan(key: PlanKey, *, autotune_enabled: bool = False,
             tune_fn: Optional[Callable[[PlanKey], Plan]] = None) -> Plan:
    """Registry -> disk cache -> measured autotune (opt-in) -> heuristic.
    A plan that would run plain PyTorch for a "cuda" key raises
    (``_checked``)."""
    with _lock:
        plan = _REGISTRY.get(key)
    if plan is not None:
        _count_resolution("memory")
        return _checked(key, plan)
    if cache_path() not in _CACHE_LOADED:
        load_cache()
        with _lock:
            plan = _REGISTRY.get(key)
        if plan is not None:
            _count_resolution("disk")
            return _checked(key, plan)
    if autotune_enabled:
        if key.seq_shards > 1:
            _count_resolution("miss_heuristic")
            return heuristic_plan(key)
        _count_resolution("miss_sweep")
        if key.family == "decode":
            return _checked(key, (tune_fn or _default_decode_tune)(key))
        return _checked(key, (tune_fn or _default_tune)(key))
    _count_resolution("miss_heuristic")
    return heuristic_plan(key)


# --------------------------------------------------------------------------
# What the CUDA kernels take.
# --------------------------------------------------------------------------
def check_tiling(block_n: int, block_c: int = 0, *, c: Optional[int] = None,
                 backward: bool = False) -> None:
    """Raise ValueError unless the CUDA kernels take this self-family
    tiling: block_c 0 or a positive multiple of ROW_TILE that divides c
    (with ``c`` unknown, any positive multiple), block_n 0 or a positive
    whole number of KEY_TILE and QUERY_TILE (K1-K3), and of
    QS_BWD_STEP_ROWS when K4 runs too."""
    from repro_torch.kernels.ss_attention import KEY_TILE, QUERY_TILE, ROW_TILE
    from repro_torch.kernels.ss_attention_bwd import QS_BWD_STEP_ROWS

    if block_c and (block_c < 0 or block_c % ROW_TILE or (c is not None and c % block_c)):
        raise ValueError(f"block_c={block_c}: K1 / K3's CTAs walk whole row tiles of "
                         f"{ROW_TILE} landmark rows; the CUDA kernels take 0 (their "
                         f"own plan) or a multiple of {ROW_TILE} that divides "
                         f"c={c}")
    quantum = math.lcm(KEY_TILE, QUERY_TILE, QS_BWD_STEP_ROWS if backward else 1)
    if block_n < 0 or block_n % quantum:
        raise ValueError(f"block_n={block_n}: the CUDA kernels take 0 (their own "
                         f"plan) or a positive multiple of {quantum}")


def _launch_counts() -> dict:
    from repro_torch.kernels import launch_counts

    return launch_counts()


def _restore_counts(before: dict) -> None:
    """Move the launches made since ``before`` from the wrappers' counts to
    ``SWEEP_LAUNCHES``."""
    from repro_torch.kernels import _wrappers

    for name, fn in _wrappers().items():
        SWEEP_LAUNCHES[name] = SWEEP_LAUNCHES.get(name, 0) + fn.launches - before[name]
        fn.launches = before[name]


def _device_for(backend: str) -> torch.device:
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a 'cuda' key is measured on a CUDA device; none is present")
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "cpu":
        return torch.device("cpu")
    raise ValueError(f"the port measures 'cuda' or 'cpu' keys, not {backend!r}")


def _prepare(dev: torch.device) -> None:
    """Build every kernel before the first timed candidate, so no ``nvcc``
    lands in a candidate's time."""
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.build()


def _seconds(fn, dev: torch.device, *, iters: int, reps: int) -> float:
    """Seconds one ``fn()`` takes: the best of ``reps`` timings of ``iters``
    back-to-back calls, after one untimed call. On the card a device-side
    wait (``torch.cuda._sleep``) holds the stream while the host enqueues
    the calls, so the CUDA events around them read device time with no
    host gaps between launches; on the CPU, the wall clock."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_HOLD_CYCLES)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            t = time.perf_counter() - t0
        best = min(best, t / iters)
    return best


# --------------------------------------------------------------------------
# Measured autotune.
# --------------------------------------------------------------------------
def reference_block_c(c: int) -> tuple[int, ...]:
    """The reference's ``block_c`` candidates at c landmarks
    (``repro/kernels/dispatch.py:379``): 0 and c / 2, c / 4 where whole and
    at least 8."""
    return (0,) + tuple(c // f for f in (2, 4) if c % f == 0 and c // f >= 8)


def _block_n_candidates(key: PlanKey, block_candidates, block_c_candidates) -> list:
    """(block_n, block_c) tilings of the fused route to time: the
    heuristic's (0, 0) first, then each candidate the kernels take at the
    key's c with K4 (whole QS_BWD_STEP_ROWS, so a plan stays valid under a
    gradient) that changes something. On the CPU and for fp32 keys nothing
    tiles, so (0, 0) alone."""
    out = [(0, 0)]
    if key.backend != "cuda" or key.dtype != "bfloat16":
        return out
    n_cap = -(-key.n // 128) * 128
    for bn in block_candidates:
        for bc in block_c_candidates:
            try:
                check_tiling(bn, bc, c=key.c, backward=True)
            except ValueError:
                continue
            cand = (min(bn, n_cap), bc)
            if cand not in out:
                out.append(cand)
    return out


def _kernel_pass(q, k, v, cfg: SSConfig, backward: bool):
    """The launches a self-family tiling reaches, at the call's shapes:
    ``run(block_n, block_c)`` launches K1 and K2 as ``ss_attention_fused``
    does (K1 with its stats when ``backward``), then K3 and K4 on a fixed
    cotangent."""
    from repro_torch.core.landmarks import segment_means
    from repro_torch.kernels.ss_attention import landmark_summary, query_side
    from repro_torch.kernels.ss_attention_bwd import landmark_summary_bwd, query_side_bwd

    b, n, d = q.shape
    c = cfg.num_landmarks
    scale = d ** -0.5
    q_l = segment_means(q, c).contiguous()
    k_l = segment_means(k, c).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(1)
    m_mat = (torch.randn((b, c, d), generator=gen) * 0.1).to(q.device, q.dtype)
    delta = torch.full((b, 1, 1), 0.1, dtype=torch.float32, device=q.device)
    g_bv = torch.randn((b, c, d), generator=gen).to(q.device, q.dtype)
    g_out = torch.randn((b, n, d), generator=gen).to(q.device, q.dtype)
    bv, m, l = landmark_summary(q_l, k, v, scale=scale, causal=cfg.causal,
                                return_stats=True)

    def run(block_n: int, block_c: int = 0) -> None:
        landmark_summary(q_l, k, v, scale=scale, causal=cfg.causal,
                         return_stats=backward, chunk_keys=block_n, row_block=block_c)
        query_side(q, k_l, m_mat, v, delta, scale=scale, causal=cfg.causal,
                   run_rows=block_n)
        if backward:
            landmark_summary_bwd(q_l, k, v, bv, m, l, g_bv, scale=scale,
                                 causal=cfg.causal, chunk_keys=block_n,
                                 row_block=block_c)
            query_side_bwd(q, k_l, m_mat, v, delta, g_out, scale=scale,
                           causal=cfg.causal, run_rows=block_n)

    return run


def autotune(n: int, c: int, d: int, dtype=torch.float32, causal: bool = False, *,
             backend: Optional[str] = None, batch: int = 1, backward: bool = False,
             block_candidates: tuple[int, ...] = (256, 512, 1024),
             block_c_candidates: Optional[tuple[int, ...]] = None, iters: int = 10,
             reps: int = 5, save: bool = True,
             cache_file: Optional[str] = None) -> Plan:
    """Measure the key's candidate plans on synthetic (batch, n, d) data of
    the key's dtype; register and (optionally) persist the fastest.
    ``SWEEPS[key.encode()]`` keeps every candidate with its seconds.

    On the card the candidates are the fused route's tilings (the heuristic's
    0 among them), each timed on the launches its tiling reaches: K1 and K2,
    and with ``backward`` (a training key) K3 and K4 as well. The jnp route
    is no candidate there: a plan never puts plain PyTorch on the card. On
    the CPU the jnp route is timed against the fused route's plain versions,
    whole calls by the wall clock. ``block_c_candidates`` defaults to the
    reference's: 0 and the divisors c / 2 and c / 4 that are whole and at
    least 8 (``reference_block_c``); the kernels take those that are
    multiples of ROW_TILE."""
    from repro_torch.kernels.ops import ss_attention_fused
    from repro_torch.telemetry.accounting import tagged_program

    _count_sweep("self")
    key = make_key(n, c, d, dtype, causal, backend=backend)
    dev = _device_for(key.backend)
    _prepare(dev)
    tdtype = getattr(torch, key.dtype)
    cfg = SSConfig(num_landmarks=c, causal=causal)
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = ((torch.randn((batch, n, d), generator=gen) * s).to(dev, tdtype)
               for s in (0.5, 0.5, 1.0))
    if block_c_candidates is None:
        block_c_candidates = reference_block_c(c)
    tilings = _block_n_candidates(key, block_candidates, block_c_candidates)
    before = _launch_counts()
    results: list[tuple[float, Plan]] = []
    try:
        with tagged_program("autotune_sweep"), torch.no_grad(), use_tiling():
            if dev.type == "cuda":
                run = _kernel_pass(q, k, v, cfg, backward)
                for bn, bc in tilings:
                    t = _seconds(partial(run, bn, bc), dev, iters=iters, reps=reps)
                    results.append((t, Plan(impl="fused", block_n=bn, block_c=bc,
                                            source="autotuned")))
            else:
                results.append((_seconds(partial(spectral_shift_attention, q, k, v, cfg),
                                         dev, iters=1, reps=reps),
                                Plan(impl="jnp", block_n=0, source="autotuned")))
                results.append((_seconds(partial(ss_attention_fused, q, k, v, cfg),
                                         dev, iters=1, reps=reps),
                                Plan(impl="fused", block_n=0, source="autotuned")))
    finally:
        _restore_counts(before)
    SWEEPS[key.encode()] = [(plan, t) for t, plan in results]
    _, plan = min(results, key=lambda r: r[0])
    register_plan(key, plan)
    if save:
        save_cache(cache_file)
    return plan


def _default_tune(key: PlanKey) -> Plan:
    return autotune(key.n, key.c, key.d, dtype=key.dtype, causal=key.causal,
                    backend=key.backend)


def autotune_decode(n: int, c: int, d: int, dtype=torch.float32, *,
                    backend: Optional[str] = None, block_size: int = 16,
                    lanes: int = 1, hkv: int = 1, rows: int = 1,
                    block_table_candidates: tuple[int, ...] = (0, 2, 4, 8),
                    chunk_slot_candidates: tuple[int, ...] = (0, 4, 8, 16),
                    iters: int = 10, reps: int = 5, save: bool = True,
                    cache_file: Optional[str] = None) -> Plan:
    """Measured autotune of the ``decode`` family at the serve shape
    (``lanes`` lanes of ``hkv`` kv heads with ``rows`` query rows each, a
    horizon of n keys in pools of ``block_size``-key blocks): K5
    (``impl="paged"``) at every view quantum (``block_table``; 0 = the whole
    table) and slot chunk (``block_n`` = ``chunk_slots``; 0 =
    ``slot_chunk_plan``'s), and on the CPU the gather route as well
    (assemble the dense views, then the one-row recompute; ``impl="jnp"``),
    which is plain PyTorch and so no candidate on the card. Each candidate
    is timed at a mid-growth and a full view. The winner registers (and
    persists) under the decode key. q and the pools are fp32, the KV
    storage's dtype whatever the key's compute dtype. Callers pass the
    deployment's real block size: the key does not encode it.
    ``SWEEPS[key.encode()]`` keeps every candidate with its seconds."""
    from repro_torch.kernels.paged_decode import paged_row_stats_lanes, slot_step
    from repro_torch.serve.decode_state import recompute_stats
    from repro_torch.serve.paged import bucket_view_slots
    from repro_torch.telemetry.accounting import tagged_program

    _count_sweep("decode")
    key = make_key(n, c, d, dtype, True, backend=backend, family="decode")
    dev = _device_for(key.backend)
    _prepare(dev)
    tdtype = torch.float32   # the KV pools' storage dtype, as the reference's
    bs = block_size
    n_full = -(-n // bs)
    gen = torch.Generator(device="cpu").manual_seed(0)
    q = (torch.randn((lanes, hkv, rows, d), generator=gen) * 0.5).to(dev, tdtype)
    pool_shape = (hkv, n_full + 1, bs, d)
    k_pool = (torch.randn(pool_shape, generator=gen) * 0.5).to(dev, tdtype)
    v_pool = torch.randn(pool_shape, generator=gen).to(dev, tdtype)
    table = torch.arange(1, n_full + 1, dtype=torch.int32, device=dev)
    views = sorted({max(n_full // 2, 1), n_full})
    scale = 1.0 / (d ** 0.5)

    def gather(nv):
        tb = table[:nv]
        kv = k_pool[:, tb].reshape(1, hkv, nv * bs, d).expand(lanes, -1, -1, -1)
        vv = v_pool[:, tb].reshape(1, hkv, nv * bs, d).expand(lanes, -1, -1, -1)
        pos = torch.full((lanes,), nv * bs - 2, dtype=torch.int32, device=dev)
        return recompute_stats(q, kv, vv, pos, scale)

    def paged(tb, kvv, cs):
        return paged_row_stats_lanes(q, (k_pool,), v_pool, tb, kvv, scale=scale,
                                     block_size=bs, chunk_slots=cs)

    step = slot_step(bs)
    chunks = [cs for cs in dict.fromkeys(chunk_slot_candidates)
              if cs == 0 or (cs % step == 0 and cs <= n_full)]
    before = _launch_counts()
    results: list[tuple[float, Plan]] = []
    try:
        with tagged_program("autotune_sweep"), torch.no_grad(), use_tiling():
            if dev.type != "cuda":
                results.append((sum(_seconds(partial(gather, nv), dev, iters=1, reps=reps)
                                    for nv in views),
                                Plan(impl="jnp", block_n=0, source="autotuned")))
            for bt in dict.fromkeys(block_table_candidates):
                for cs in chunks:
                    t = 0.0
                    for nv in views:
                        nv_r = n_full if bt == 0 else bucket_view_slots(nv, n_full, bt)
                        tb = torch.zeros((lanes, nv_r), dtype=torch.int32, device=dev)
                        tb[:, :nv] = table[:nv]
                        kvv = torch.full((lanes,), nv * bs - 1, dtype=torch.int32,
                                         device=dev)
                        t += _seconds(partial(paged, tb, kvv, cs), dev,
                                      iters=iters if dev.type == "cuda" else 1, reps=reps)
                    results.append((t, Plan(impl="paged", block_n=cs, block_table=bt,
                                            source="autotuned")))
    finally:
        _restore_counts(before)
    SWEEPS[key.encode()] = [(plan, t) for t, plan in results]
    _, plan = min(results, key=lambda r: r[0])
    register_plan(key, plan)
    if save:
        save_cache(cache_file)
    return plan


def _default_decode_tune(key: PlanKey) -> Plan:
    return autotune_decode(key.n, key.c, key.d, dtype=key.dtype, backend=key.backend)


# --------------------------------------------------------------------------
# Model-facing entry point.
# --------------------------------------------------------------------------
def dispatch_ss_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cfg: SSConfig, *, scale: Optional[float] = None,
                          backend: str = "auto",
                          autotune_enabled: bool = False) -> torch.Tensor:
    """Route one attention call through the registry. ``backend``: "auto"
    resolves a plan for the call's key (a sweep, when enabled, measures at
    this call's batch); "fused" / "jnp" / "sharded" force that route at
    the kernels' own tiling ("sharded" outside a sequence shard is
    "fused", as in the reference). "interpret" is the reference's Pallas
    interpret mode: on the CPU it runs the plain versions (the port's
    counterpart), on CUDA it raises. On CUDA "auto" resolves to the
    kernels only (``get_plan``). Under an active sequence shard
    (``distributed.sharding.active_seq_sharding``) q, k, v are the rank's
    rows and a kernel route runs the context-parallel attention (module
    docstring). Shapes (..., n, d); differentiable on every route."""
    from repro_torch.distributed.sharding import active_seq_sharding
    from repro_torch.kernels.ops import ss_attention_fused

    n, d = q.shape[-2], q.shape[-1]
    mesh, seq_axes, _ = active_seq_sharding()
    n_shards = mesh.axis_size(seq_axes) if seq_axes else 1
    if n_shards > 1 and n != k.shape[-2]:
        raise NotImplementedError(
            f"attention with n_q={n} != n_k={k.shape[-2]} under a sequence shard: the "
            f"context-parallel attention is self-attention only")
    if backend == "auto":
        key = make_key(n * n_shards, cfg.num_landmarks, d, q.dtype, cfg.causal,
                       backend=q.device.type, seq_shards=n_shards)
        batch = math.prod(q.shape[:-2])

        def tune(k_):
            return autotune(k_.n, k_.c, k_.d, dtype=k_.dtype, causal=k_.causal,
                            backend=k_.backend, batch=batch,
                            backward=torch.is_grad_enabled() and q.requires_grad)

        plan = get_plan(key, autotune_enabled=autotune_enabled, tune_fn=tune)
        impl, block_n, block_c = plan.impl, plan.block_n, plan.block_c
    elif backend in _IMPLS:
        impl, block_n, block_c = backend, 0, 0
    else:
        raise ValueError(f"unknown attention backend {backend!r}; want 'auto' or "
                         f"one of {_IMPLS}")
    if impl == "paged":
        raise ValueError("'paged' plans serve the decode key family (block-pool "
                         "serving ticks); self-attention sites cannot route through it")
    if impl == "jnp":
        if n_shards > 1:
            raise NotImplementedError(
                "the plain-torch ('jnp') route under a sequence shard would attend "
                "over the rank's own rows only; use a kernel route")
        return spectral_shift_attention(q, k, v, cfg, scale=scale)
    if impl == "interpret" and q.is_cuda:
        raise ValueError("'interpret' is the reference's Pallas interpret mode; "
                         "on CUDA the port runs its kernels ('fused')")
    if n_shards > 1:
        from repro_torch.kernels.sharded import ss_attention_fused_sharded

        return ss_attention_fused_sharded(q, k, v, cfg, mesh=mesh, seq_axes=seq_axes,
                                          scale=scale, block_n=block_n)
    return ss_attention_fused(q, k, v, cfg, scale=scale, block_n=block_n,
                              block_c=block_c)
