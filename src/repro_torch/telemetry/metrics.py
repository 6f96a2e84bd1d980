"""Metrics registry: counters, gauges and fixed-bucket histograms (the
port's own copy of ``repro/telemetry/metrics.py``).

One registry backs every ``stats()`` view in the serving/training stack so
aggregate bookkeeping lives in exactly one place. Three metric kinds:

* ``Counter`` — monotone float, ``inc(n)``;
* ``Gauge`` — point-in-time value, either ``set(v)`` or a zero-hot-path
  callback (``fn=...``) evaluated only when the gauge is *read*;
* ``Histogram`` — fixed bucket bounds, so p50/p90/p99 are derivable from
  the per-bucket counts without storing samples. Percentiles are reported
  as the **upper bound of the bucket holding the target rank** (the
  conservative Prometheus-style estimate); when every observation in range
  shares one value the reported percentile is exact, which keeps
  tick-valued histograms (unit buckets) exact for the scheduler's
  TTFT/latency views.

Labeled *families* let one metric name cover a whole ``impl|mode|horizon``
grid: ``registry.counter("x", labels=("impl",)).labels(impl="paged").inc()``
— children are created on first use and share the family's buckets/help.

``NullRegistry`` mirrors the full API with shared no-op objects: metric
calls on it are attribute lookups that drop their arguments, it never
retains a reference to anything, and ``snapshot()`` is ``{}`` — the
zero-overhead backing for disabled telemetry (``ServeConfig.telemetry``)
and for the module-level default in ``telemetry/accounting.py``.
"""
from __future__ import annotations

import bisect
import threading
from typing import Callable, Optional, Sequence


def exp_buckets(lo: float, hi: float, per_decade: int = 3) -> tuple[float, ...]:
    """Exponential bucket bounds from ``lo`` to >= ``hi`` with
    ``per_decade`` bounds per decade (3 -> 1, 2.15, 4.64 pattern)."""
    if lo <= 0 or hi <= lo:
        raise ValueError("need 0 < lo < hi")
    out = []
    b = lo
    factor = 10.0 ** (1.0 / per_decade)
    while b < hi * (1 + 1e-9):
        out.append(b)
        b *= factor
    return tuple(out)


# Wall-clock latencies (seconds): 20 us .. ~100 s.
LATENCY_BUCKETS = exp_buckets(2e-5, 100.0, per_decade=4)
# Engine-tick counts: exact up to 64 ticks (unit buckets), then pow2.
TICK_BUCKETS = tuple(float(i) for i in range(1, 65)) + tuple(
    float(2 ** i) for i in range(7, 15)
)
# Dimensionless ratios in [0, 1]-ish (drift residuals, occupancy).
RATIO_BUCKETS = exp_buckets(1e-6, 10.0, per_decade=3)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def sample(self) -> dict:
        return {"value": self.value}


class Gauge:
    __slots__ = ("_value", "fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        if self.fn is not None:
            return float(self.fn())
        return self._value

    def sample(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bound histogram; final overflow bucket is implicit (+inf)."""

    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: Sequence[float] = LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if list(bounds) != sorted(set(bounds)) or not bounds:
            raise ValueError("histogram bounds must be sorted and distinct")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # [..., overflow]
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        # bucket i covers (bounds[i-1], bounds[i]]
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v

    def percentile(self, p: float) -> Optional[float]:
        """Upper bound of the bucket holding rank ceil(p% of count); the
        overflow bucket reports the largest finite bound. None when empty."""
        if self.count == 0:
            return None
        target = (p / 100.0) * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            cum += n
            if n > 0 and cum >= target:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def sample(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class Family:
    """Labeled metric family: one name, one child metric per label-set."""

    def __init__(self, make: Callable[[], object], label_names: tuple[str, ...]):
        self._make = make
        self.label_names = label_names
        self.children: dict[tuple, object] = {}

    def labels(self, **kv):
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"expected labels {self.label_names}, got {tuple(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self.children.get(key)
        if child is None:
            child = self.children[key] = self._make()
            return child
        return child


class MetricsRegistry:
    """Name -> metric (or labeled family). Registration is idempotent:
    re-registering a name returns the existing object (kind mismatch
    raises), so modules can declare their metrics independently."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, tuple[str, object, str]] = {}  # kind, obj, help

    def _register(self, name, kind, make, labels, help):
        with self._lock:
            hit = self._metrics.get(name)
            if hit is not None:
                if hit[0] != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {hit[0]}"
                    )
                return hit[1]
            obj = Family(make, tuple(labels)) if labels else make()
            self._metrics[name] = (kind, obj, help)
            return obj

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()):
        return self._register(name, "counter", Counter, labels, help)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = (),
              fn: Optional[Callable[[], float]] = None):
        return self._register(name, "gauge", lambda: Gauge(fn), labels, help)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS):
        return self._register(
            name, "histogram", lambda: Histogram(buckets), labels, help
        )

    def get(self, name: str):
        hit = self._metrics.get(name)
        return hit[1] if hit else None

    # -- export ---------------------------------------------------------------
    def iter_samples(self):
        """Yield ``(name, kind, labels_dict, sample_dict)`` for every child
        metric (families expand to one row per label-set)."""
        with self._lock:
            items = list(self._metrics.items())
        for name, (kind, obj, _help) in items:
            if isinstance(obj, Family):
                for key, child in sorted(obj.children.items()):
                    yield name, kind, dict(zip(obj.label_names, key)), \
                        child.sample()
            else:
                yield name, kind, {}, obj.sample()

    def snapshot(self) -> dict:
        """Nested dict view: ``{name: sample}`` for plain metrics,
        ``{name: {"label=v,...": sample}}`` for families."""
        out: dict = {}
        for name, _kind, labels, sample in self.iter_samples():
            if labels:
                key = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                out.setdefault(name, {})[key] = sample
            else:
                out[name] = sample
        return out


# --------------------------------------------------------------------------
# The zero-overhead null implementation.
# --------------------------------------------------------------------------
class _NullMetric:
    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, p: float):
        return None

    def labels(self, **kv):
        return self

    value = 0.0
    count = 0
    sum = 0.0

    def sample(self) -> dict:
        return {}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """API-compatible no-op registry: every call returns the one shared
    null metric, nothing is retained, ``snapshot()`` is empty."""

    def counter(self, name, help="", labels=()):
        return _NULL_METRIC

    def gauge(self, name, help="", labels=(), fn=None):
        return _NULL_METRIC

    def histogram(self, name, help="", labels=(), buckets=LATENCY_BUCKETS):
        return _NULL_METRIC

    def get(self, name):
        return None

    def iter_samples(self):
        return iter(())

    def snapshot(self) -> dict:
        return {}
