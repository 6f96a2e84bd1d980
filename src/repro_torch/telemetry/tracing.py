"""Tick-level tracing: lightweight host-side spans with JSONL export (the
port's counterpart of ``repro/telemetry/tracing.py``).

``with tracer.span("decode_dispatch", lanes=4):`` records one event with
monotonic host timing (``time.perf_counter``) into a bounded in-memory
buffer; nesting depth is tracked so a JSONL dump rebuilds the tick
structure offline. Each span also feeds the ``span_seconds{span=}``
histogram family of the attached registry, so p50/p99 per span name ride
in the same snapshot as every other metric.

A span is host time only. On CUDA the device runs behind the host, so a
span that launches work ends before that work does: the host's wait for
the device shows up in whichever span first syncs (the engine's
``device_sync``, or a hidden sync inside ``decode_dispatch``). No span
synchronizes to make itself "accurate".

``annotate=True`` also wraps every span in
``torch.profiler.record_function`` so the span names appear in a
``torch.profiler`` trace beside the kernels they launched; ``step_span``
puts the step number in the annotation's name (``"train_step#3"``). The
reference uses ``jax.profiler.TraceAnnotation`` / ``StepTraceAnnotation``
there. Both default off: an annotation costs a profiler call per span.

``NullTracer`` is the disabled twin: ``span()`` returns one shared no-op
context manager, records nothing, and ``dump_jsonl`` writes nothing.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

from repro_torch.telemetry.metrics import LATENCY_BUCKETS, MetricsRegistry


class _Span:
    """Context manager recording one event into the tracer's buffer."""

    __slots__ = ("tracer", "name", "labels", "annotation", "_t0")

    def __init__(self, tracer, name, labels, annotation):
        self.tracer = tracer
        self.name = name
        self.labels = labels
        self.annotation = annotation
        self._t0 = 0.0

    def __enter__(self):
        tl = self.tracer._tls
        tl.depth = getattr(tl, "depth", 0) + 1
        if self.annotation is not None:
            self.annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        tl = self.tracer._tls
        depth = tl.depth
        tl.depth = depth - 1
        self.tracer._record(self.name, self._t0, dur, depth - 1, self.labels)
        return False


def _annotation(name: str):
    from torch.profiler import record_function

    return record_function(name)


class Tracer:
    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        annotate: bool = False,
        max_events: int = 200_000,
    ):
        self.annotate = annotate
        self.max_events = max_events
        self.events: list[dict] = []
        self.dropped = 0
        self._tls = threading.local()
        self._origin = time.perf_counter()
        self._span_hist = (
            registry.histogram(
                "span_seconds", help="host wall time per span name",
                labels=("span",), buckets=LATENCY_BUCKETS,
            )
            if registry is not None else None
        )

    @property
    def enabled(self) -> bool:
        return True

    def span(self, name: str, **labels) -> _Span:
        annotation = _annotation(name) if self.annotate else None
        return _Span(self, name, labels or None, annotation)

    def step_span(self, name: str, step: int):
        """Training-step span: the same event record; under ``annotate``
        the profiler annotation is named ``"<name>#<step>"`` so a trace
        groups device work per step."""
        annotation = _annotation(f"{name}#{step}") if self.annotate else None
        return _Span(self, name, {"step": step}, annotation)

    def _record(self, name, t0, dur, depth, labels):
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        ev = {
            "name": name,
            "t": round(t0 - self._origin, 9),  # monotonic, tracer-relative
            "dur_s": round(dur, 9),
            "depth": depth,
        }
        if labels:
            ev["labels"] = labels
        self.events.append(ev)
        if self._span_hist is not None:
            self._span_hist.labels(span=name).observe(dur)

    def summary(self) -> dict:
        return {"events": len(self.events), "dropped": self.dropped}

    def dump_jsonl(self, fh) -> int:
        """Write one ``{"kind": "span", ...}`` line per event; returns the
        number of lines written."""
        n = 0
        for ev in self.events:
            fh.write(json.dumps({"kind": "span", **ev}) + "\n")
            n += 1
        return n


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    enabled = False
    events: list = []
    dropped = 0

    def span(self, name: str, **labels):
        return _NULL_SPAN

    def step_span(self, name: str, step: int):
        return _NULL_SPAN

    def summary(self) -> dict:
        return {"events": 0, "dropped": 0}

    def dump_jsonl(self, fh) -> int:
        return 0
