"""Program accounting, kernel-build accounting and numerics probes (the
port's counterpart of ``repro/telemetry/accounting.py``).

The reference counts XLA compiles: a jitted program compiles once per
distinct argument signature, and a steady-state engine must show that
count flat. The port runs eagerly, so nothing compiles; what it can
count is the same thing the compile cache keys on.

1. **Argument signatures per program.** :class:`ProgramAccounting.wrap`
   instruments one of the engine's programs (``prefill``,
   ``prefill_chunk``, ``decode_tick``, ``rebase``, ``prefix_attach``,
   ``decode_exact``). Each call counts in ``program_calls_total{program=}``;
   a call whose signature was not seen before counts in
   ``program_shapes_total{program=}``, with its wall time in
   ``program_first_call_seconds{program=}``. The signature is what the
   reference's ``jax.jit`` keys on: the shape and dtype of every tensor
   and array argument (inside lists, tuples, dicts and dataclasses too),
   plus the values of the arguments named ``static``: host ints that the
   reference turns into shapes before its jit (a view's block count).
   Every other host scalar, such as a chunk's start position, is a traced
   operand in the reference and stays out. A shape-bucket leak shows as
   growth of ``program_shapes_total`` over steady-state ticks.

2. **Kernel builds.** The counterpart of the reference's backend-compile
   listener: ``kernels/build.py`` calls :func:`note_kernel_build` after
   each ``nvcc`` build, which counts ``kernel_builds_total{program=}``
   under the innermost :func:`tagged_program` region (``"untagged"``
   outside one) and observes ``kernel_build_seconds``. It routes through
   a module-level registry holder, a no-op until :func:`set_metrics`
   points it at a live registry. The holder keeps a weak reference: an
   engine's registry reaches the engine (its fn-gauges read the pool and
   the scheduler), so a strong one would keep the last telemetry-on
   engine, weights and all, alive after its owner dropped it.

3. **Numerical poisoning.** :class:`NumericsProbe` counts non-finite
   elements per probe site (``numerics_nonfinite_total{site=}``). A torch
   tensor is counted where it lies (on the card: one reduction and a
   one-scalar sync); a numpy array on the host. Integer tensors count 0.
   The engine calls it every ``ServeConfig.numerics_probe_every`` ticks.

XLA's cost analysis (the reference's ``compiled_cost``) has no eager
counterpart here; its one user, ``bench_decode``, is not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
import weakref
from typing import Optional

import numpy as np

from repro_torch.telemetry.metrics import NullRegistry

_NULL = NullRegistry()
_metrics_ref = None  # weakref to the live registry, or None
_tls = threading.local()
BUILD_BUCKETS = (0.01, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0)


def set_metrics(registry) -> None:
    """Point module-level accounting (the kernel-build hook) at a live
    registry (held weakly). ``None`` restores the null registry."""
    global _metrics_ref
    _metrics_ref = weakref.ref(registry) if registry is not None else None


def _metrics():
    registry = _metrics_ref() if _metrics_ref is not None else None
    return registry if registry is not None else _NULL


def current_program() -> str:
    """Name of the innermost active :func:`tagged_program` region."""
    stack = getattr(_tls, "programs", None)
    return stack[-1] if stack else "untagged"


@contextlib.contextmanager
def tagged_program(name: str):
    """Attribute any kernel build that runs inside this region to ``name``
    (thread-local; regions nest, innermost wins)."""
    stack = getattr(_tls, "programs", None)
    if stack is None:
        stack = _tls.programs = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def note_kernel_build(seconds: float) -> None:
    """One ``nvcc`` build of ``seconds`` wall time, attributed to the
    active :func:`tagged_program` region."""
    registry = _metrics()
    registry.counter(
        "kernel_builds_total", help="nvcc builds of a kernel library",
        labels=("program",)).labels(program=current_program()).inc()
    registry.histogram(
        "kernel_build_seconds", help="wall time of each nvcc build",
        buckets=BUILD_BUCKETS).observe(seconds)


def _leaf_signature(x):
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:  # torch tensor / numpy array
        return (tuple(shape), str(dtype))
    if isinstance(x, dict):
        return tuple((k, _leaf_signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        sig = tuple(_leaf_signature(v) for v in x)
        # a list of host scalars (lane ids) is a fixed-shape traced array
        # in the reference
        return None if all(v is None for v in sig) else sig
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple(_leaf_signature(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    return None  # a host scalar: traced in the reference, not in the key


def arg_signature(args, kwargs, static=()) -> tuple:
    """The compile-cache key of a call: tensor / array shapes and dtypes,
    with the ``static`` positional indices (ints) or keyword names (strs)
    by value."""
    pos = tuple(a if i in static else _leaf_signature(a)
                for i, a in enumerate(args))
    kw = tuple((k, v if k in static else _leaf_signature(v))
               for k, v in sorted(kwargs.items()))
    return pos + kw


class ProgramAccounting:
    """Per-program call and signature counters over wrapped callables."""

    def __init__(self, registry):
        self._shapes = registry.counter(
            "program_shapes_total",
            help="distinct argument signatures per instrumented program",
            labels=("program",))
        self._calls = registry.counter(
            "program_calls_total", help="calls per instrumented program",
            labels=("program",))
        self._first_s = registry.histogram(
            "program_first_call_seconds",
            help="wall time of each program's first call at a new signature",
            labels=("program",), buckets=BUILD_BUCKETS)
        self._seen: dict[str, set] = {}

    def wrap(self, fn, program: str, static=()):
        """Instrument ``fn``: count its calls and first-seen argument
        signatures (see :func:`arg_signature`), and tag the call so a
        kernel build inside it is attributed to ``program``."""
        calls = self._calls.labels(program=program)
        shapes = self._shapes.labels(program=program)
        first_s = self._first_s.labels(program=program)
        seen = self._seen.setdefault(program, set())

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            calls.inc()
            sig = arg_signature(args, kwargs, static)
            new = sig not in seen
            t0 = time.perf_counter()
            with tagged_program(program):
                out = fn(*args, **kwargs)
            if new:
                seen.add(sig)
                shapes.inc()
                first_s.observe(time.perf_counter() - t0)
            return out

        return wrapped

    def shapes(self, program: str) -> int:
        return int(self._shapes.labels(program=program).value)


class NumericsProbe:
    """Non-finite counters per probe site. A CUDA tensor costs a
    reduction on the card and a one-scalar sync: gate the call frequency
    at the call site."""

    def __init__(self, registry):
        self._nonfinite = registry.counter(
            "numerics_nonfinite_total",
            help="non-finite elements observed per probe site",
            labels=("site",))
        self._checks = registry.counter(
            "numerics_checks_total", help="numerics probe invocations")
        self.last_bad: Optional[str] = None

    def check(self, site: str, arr) -> int:
        """Count the non-finite elements of ``arr`` (a torch tensor, on
        its own device, or a numpy array) under ``site``; returns the
        count and remembers the most recent offending site."""
        self._checks.inc()
        if isinstance(arr, np.ndarray):
            if arr.dtype.kind not in "fc":
                return 0
            bad = int(arr.size - np.count_nonzero(np.isfinite(arr)))
        else:
            if not (arr.is_floating_point() or arr.is_complex()):
                return 0
            bad = int(arr.numel() - int(arr.isfinite().sum()))
        if bad:
            self._nonfinite.labels(site=site).inc(bad)
            self.last_bad = site
        return bad


class NullNumericsProbe:
    """Disabled twin: never syncs, never counts."""

    last_bad = None

    def check(self, site: str, arr) -> int:
        return 0
