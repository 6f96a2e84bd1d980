"""Telemetry for the port: metrics registry, tick tracing, flight
recorder, Perfetto export, drift and spectrum monitors, numerics probe
and program accounting (the counterpart of ``repro/telemetry/``, with its
module, class, metric family and span names and its JSONL schema).

``Telemetry`` is the one object the engine and the trainer hold. It
bundles a :class:`~repro_torch.telemetry.metrics.MetricsRegistry`, a
:class:`~repro_torch.telemetry.tracing.Tracer` and a
:class:`~repro_torch.telemetry.flight.FlightRecorder` (sharing the
tracer's ``perf_counter`` origin) and exports them two ways:

* ``snapshot()``: a nested dict of every metric sample plus the span
  buffer's counters; cheap, safe mid-run;
* ``dump_jsonl(path)``: one self-describing JSONL file: a ``meta`` line
  (schema ``"repro-telemetry-v1"`` and the provenance stamp), one
  ``metric`` line per (name, label set), one ``span`` line per traced
  event and one ``flight`` line per retained lifeline.

``Telemetry(enabled=False)`` (or :func:`null_telemetry`) swaps in the
no-op registry, tracer and recorder: every instrumentation site still
calls telemetry, but each call is a shared-object no-op, nothing is
retained, nothing touches the device, and dumps write nothing.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.telemetry.accounting import (  # noqa: F401
    NullNumericsProbe,
    NumericsProbe,
    ProgramAccounting,
    arg_signature,
    tagged_program,
)
from repro_torch.telemetry.export import (  # noqa: F401
    chrome_trace,
    profile_session,
    validate_trace,
    write_chrome_trace,
)
from repro_torch.telemetry.flight import FlightRecorder, NullFlightRecorder  # noqa: F401
from repro_torch.telemetry.metrics import (  # noqa: F401  (re-exports)
    LATENCY_BUCKETS,
    RATIO_BUCKETS,
    TICK_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    exp_buckets,
)
from repro_torch.telemetry.monitors import (  # noqa: F401
    DriftMonitor,
    SpectrumMonitor,
    bv_from_stats,
    bv_row_residual,
    spectrum_mass,
)
from repro_torch.telemetry.provenance import config_hash, git_sha, provenance  # noqa: F401
from repro_torch.telemetry.tracing import NullTracer, Tracer  # noqa: F401


class Telemetry:
    """Bundle of one metrics registry, one tracer and one flight recorder
    with JSONL export."""

    def __init__(
        self,
        enabled: bool = True,
        *,
        registry: Optional[MetricsRegistry] = None,
        annotate: bool = False,
        max_events: int = 200_000,
    ):
        self.enabled = enabled
        self.meta_defaults: dict = {}
        if enabled:
            self.metrics = registry if registry is not None else MetricsRegistry()
            self.tracer = Tracer(
                self.metrics, annotate=annotate, max_events=max_events
            )
            self.flight = FlightRecorder(
                registry=self.metrics, origin=self.tracer._origin
            )
        else:
            self.metrics = NullRegistry()
            self.tracer = NullTracer()
            self.flight = NullFlightRecorder()

    def stamp_provenance(self, *cfgs, device=None) -> None:
        """Record the provenance stamp (git SHA, torch / CUDA versions, the
        card's name for a CUDA ``device``, the joint hash of ``cfgs``) into
        ``meta_defaults`` so every later dump and trace carries it."""
        if self.enabled:
            self.meta_defaults.update(provenance(*cfgs, device=device))

    def span(self, name: str, **labels):
        return self.tracer.span(name, **labels)

    def step_span(self, name: str, step: int):
        return self.tracer.step_span(name, step)

    def snapshot(self) -> dict:
        return {"metrics": self.metrics.snapshot(), "spans": self.tracer.summary()}

    def dump_jsonl(self, path, meta: Optional[dict] = None) -> int:
        """Write the full telemetry state as JSONL; returns lines written.
        Disabled telemetry writes nothing (and creates no file)."""
        if not self.enabled:
            return 0
        n = 0
        with open(path, "w") as fh:
            head = {"kind": "meta", "schema": "repro-telemetry-v1"}
            head.update(self.meta_defaults)
            if meta:
                head.update(meta)
            fh.write(json.dumps(head) + "\n")
            n += 1
            for name, kind, labels, sample in self.metrics.iter_samples():
                row = {"kind": "metric", "name": name, "type": kind}
                if labels:
                    row["labels"] = labels
                row.update(sample)
                fh.write(json.dumps(row) + "\n")
                n += 1
            n += self.tracer.dump_jsonl(fh)
            n += self.flight.dump_jsonl(fh)
        return n


def null_telemetry() -> Telemetry:
    return Telemetry(enabled=False)
