"""Chrome Trace Event Format export for Perfetto / chrome://tracing (the
port's counterpart of ``repro/telemetry/export.py``; ``chrome_trace``,
``validate_trace`` and ``write_chrome_trace`` are copies).

Takes one :class:`~repro_torch.telemetry.Telemetry` bundle and renders
its two event stores onto a single timeline:

* the host span buffer (``telemetry.tracer.events``) as nested duration
  events on a ``host`` process track: every engine tick's admit /
  prefill / decode_dispatch / device_sync / sample_emit spans;
* the flight recorder's per-request lifelines (``telemetry.flight``) as
  one thread track per request: an enveloping ``request`` slice from
  submit to finish, with ``queued`` / ``prefill`` / ``prefill_chunk`` /
  ``decode`` slices nested inside and instant markers for preempt /
  requeue / rebase / finish;
* flight counter samples (pool occupancy, fragmentation, queue depth) as
  Perfetto counter tracks.

Both stores share one ``perf_counter`` origin, so host spans and request
lifelines line up. Load the written JSON at https://ui.perfetto.dev or
``chrome://tracing``. Timestamps are microseconds.

For the device timeline, :func:`profile_session` runs a block under
``torch.profiler`` and writes the profiler's own Chrome trace; with
``Telemetry(annotate=True)`` the spans appear there by name.
"""
from __future__ import annotations

import contextlib
import json
from typing import Optional

_US = 1e6

# pid assignments: one "process" per data source.
PID_HOST = 0
PID_REQUESTS = 1
PID_COUNTERS = 2


def _dur_events(out, *, pid, tid, name, t0_us, t1_us, depth, args=None):
    b = {"ph": "B", "pid": pid, "tid": tid, "name": name,
         "ts": round(t0_us, 3), "_depth": depth}
    if args:
        b["args"] = args
    e = {"ph": "E", "pid": pid, "tid": tid, "name": name,
         "ts": round(max(t1_us, t0_us), 3), "_depth": depth}
    out.append(b)
    out.append(e)


def _instant(out, *, pid, tid, name, t_us, args=None):
    ev = {"ph": "i", "pid": pid, "tid": tid, "name": name,
          "ts": round(t_us, 3), "s": "t", "_depth": 0}
    if args:
        ev["args"] = args
    out.append(ev)


def _meta(out, *, pid, name, tid=None, value=""):
    ev = {"ph": "M", "pid": pid, "name": name, "ts": 0,
          "args": {"name": value}}
    if tid is not None:
        ev["tid"] = tid
    out.append(ev)


def _host_events(tracer, out) -> None:
    for ev in tracer.events:
        t0 = ev["t"] * _US
        _dur_events(
            out, pid=PID_HOST, tid=0, name=ev["name"],
            t0_us=t0, t1_us=t0 + ev["dur_s"] * _US,
            depth=ev["depth"], args=ev.get("labels"))


def _lifeline_events(line, out) -> None:
    """One request's lifeline → an enveloping ``request`` slice with
    sequential ``queued``/``prefill``/``decode`` slices nested inside."""
    events = line.events
    if not events:
        return
    tid = line.uid
    t_first = events[0]["t"] * _US
    t_last = max(ev.get("t1", ev["t"]) for ev in events) * _US

    slices = []      # (name, t0_us, t1_us, args)
    instants = []    # (name, t_us, args)
    open_name: Optional[str] = None
    open_t0 = 0.0
    open_args: Optional[dict] = None

    def close(t1_us, default_args=None):
        nonlocal open_name, open_args
        if open_name is not None:
            slices.append((open_name, open_t0,
                           max(t1_us, open_t0), open_args or default_args))
            open_name = None
            open_args = None

    for ev in events:
        t = ev["t"] * _US
        kind = ev["kind"]
        if kind == "submit":
            open_name, open_t0 = "queued", t
            open_args = {"prompt_len": ev.get("prompt_len")}
        elif kind == "admit":
            close(t)
            instants.append(("admit", t, {"lane": ev.get("lane")}))
        elif kind == "prefill_start":
            close(t)
            open_name, open_t0 = "prefill", t
            open_args = {"bucket": ev.get("bucket")}
        elif kind == "prefill_end":
            close(t, {"bucket": ev.get("bucket")})
        elif kind == "prefill_chunk":
            close(t)
            t1 = ev.get("t1", ev["t"]) * _US
            slices.append(("prefill_chunk", t, max(t1, t),
                           {"tick0": ev.get("tick0"), "tick1": ev.get("tick1"),
                            "chunk0": ev.get("chunk0"),
                            "chunk1": ev.get("chunk1"),
                            "tok0": ev.get("tok0"), "tok1": ev.get("tok1"),
                            "lane": ev.get("lane"), "chunks": ev.get("n")}))
        elif kind == "decode":
            close(t)
            t1 = ev.get("t1", ev["t"]) * _US
            slices.append(("decode", t, max(t1, t),
                           {"tick0": ev.get("tick0"), "tick1": ev.get("tick1"),
                            "pos0": ev.get("pos0"), "pos1": ev.get("pos1"),
                            "ticks": ev.get("n")}))
        elif kind == "prefix_attach":
            # Prefix-cache hit at admission: the shared span never prefills,
            # so the lifeline shows an instant (full hit: first token comes
            # straight from cached logits; partial: chunked prefill resumes
            # at the attach boundary, its chunks render as usual).
            close(t)
            instants.append(("prefix_attach", t, {
                "lane": ev.get("lane"), "blocks": ev.get("blocks"),
                "tokens": ev.get("tokens"), "mode": ev.get("mode")}))
        elif kind == "cow":
            instants.append(("cow", t, {"src": ev.get("src"),
                                        "dst": ev.get("dst")}))
        elif kind == "preempt":
            close(t)
            instants.append(("preempt", t, {"lane": ev.get("lane"),
                                            "parked": ev.get("parked")}))
        elif kind == "park_drop":
            instants.append(("park_drop", t, None))
        elif kind == "requeue":
            close(t)
            open_name, open_t0, open_args = "queued", t, {"requeue": True}
        elif kind == "rebase":
            instants.append(("rebase", t, None))
        elif kind == "reject":
            # Bounded-queue backpressure: the uid never entered the engine.
            instants.append(("reject", t, {
                "queue_depth": ev.get("queue_depth"),
                "retry_after_ticks": ev.get("retry_after_ticks")}))
        elif kind in ("cancel", "deadline"):
            close(t)
            instants.append((kind, t, {"tick": ev.get("tick")}))
        elif kind == "quarantine":
            # Numerics guard: stats rebuilt in place from cached K/V.
            instants.append(("quarantine", t, {
                "lane": ev.get("lane"), "trips": ev.get("trips")}))
        elif kind == "demote":
            instants.append(("demote", t, {"trips": ev.get("trips")}))
        elif kind in ("chaos", "watchdog"):
            # Engine-scoped events (uid -1): chaos injections carry their
            # site, watchdog fires their escalation rung.
            instants.append((kind, t, {
                k: v for k, v in ev.items() if k not in ("kind", "t", "t1")}))
        elif kind == "finish":
            close(t)
            instants.append(
                ("finish", t, {"tokens": ev.get("tokens"),
                               "reason": ev.get("reason")}))
    close(t_last)  # clamp any still-open slice at the lifeline's end

    _dur_events(out, pid=PID_REQUESTS, tid=tid, name="request",
                t0_us=t_first, t1_us=t_last, depth=0,
                args={"uid": line.uid, "dropped_events": line.dropped})
    for name, t0, t1, args in slices:
        _dur_events(out, pid=PID_REQUESTS, tid=tid, name=name,
                    t0_us=t0, t1_us=min(t1, t_last), depth=1, args=args)
    for name, t, args in instants:
        _instant(out, pid=PID_REQUESTS, tid=tid, name=name, t_us=t, args=args)


def _counter_events(flight, out) -> None:
    for name, samples in flight.counters.items():
        for t, v in samples:
            out.append({"ph": "C", "pid": PID_COUNTERS, "tid": 0,
                        "name": name, "ts": round(t * _US, 3),
                        "args": {"value": v}, "_depth": 0})


def _sort_key(ev):
    # At equal ts: close deepest-first, then metadata/instants/counters,
    # then open shallowest-first — keeps every track's B/E stack balanced.
    ph = ev["ph"]
    depth = ev.get("_depth", 0)
    if ph == "E":
        return (ev["ts"], 0, -depth)
    if ph == "B":
        return (ev["ts"], 2, depth)
    return (ev["ts"], 1, 0)


def chrome_trace(telemetry, meta: Optional[dict] = None) -> dict:
    """Render a Telemetry bundle as a Chrome Trace Event Format dict."""
    out: list[dict] = []
    _meta(out, pid=PID_HOST, name="process_name", value="host (engine loop)")
    _meta(out, pid=PID_HOST, tid=0, name="thread_name", value="tick spans")

    _host_events(telemetry.tracer, out)

    lifelines = telemetry.flight.lifelines()
    if lifelines:
        _meta(out, pid=PID_REQUESTS, name="process_name", value="requests")
        for line in lifelines:
            _meta(out, pid=PID_REQUESTS, tid=line.uid, name="thread_name",
                  value=f"req {line.uid}")
            _lifeline_events(line, out)

    if telemetry.flight.counters:
        _meta(out, pid=PID_COUNTERS, name="process_name", value="counters")
        _counter_events(telemetry.flight, out)

    out.sort(key=_sort_key)
    for ev in out:
        ev.pop("_depth", None)

    trace = {"traceEvents": out, "displayTimeUnit": "ms"}
    trace["metadata"] = dict(meta or {})
    trace["metadata"].setdefault("trace_schema", "repro-chrome-trace-v1")
    return trace


def validate_trace(trace: dict) -> list[str]:
    """Structural checks a viewer needs: per-(pid, tid) track, B/E events
    balance as a stack and timestamps never go backwards. Returns a list
    of violations (empty == valid)."""
    errors: list[str] = []
    stacks: dict[tuple, list[str]] = {}
    last_ts: dict[tuple, float] = {}
    for i, ev in enumerate(trace.get("traceEvents", [])):
        ph = ev.get("ph")
        if ph == "M":
            continue
        key = (ev.get("pid"), ev.get("tid"))
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            errors.append(f"event {i}: non-numeric ts {ts!r}")
            continue
        if ts < last_ts.get(key, float("-inf")):
            errors.append(
                f"event {i}: ts {ts} < previous {last_ts[key]} on track {key}")
        last_ts[key] = ts
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name", ""))
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                errors.append(f"event {i}: E without open B on track {key}")
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            errors.append(f"track {key}: {len(stack)} unclosed B events")
    return errors


def write_chrome_trace(path, telemetry, meta: Optional[dict] = None) -> int:
    """Write the trace JSON to ``path``; returns the event count. Merges
    the telemetry bundle's ``meta_defaults`` (provenance) into metadata."""
    defaults = dict(getattr(telemetry, "meta_defaults", {}) or {})
    defaults.update(meta or {})
    trace = chrome_trace(telemetry, meta=defaults)
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return len(trace["traceEvents"])


@contextlib.contextmanager
def profile_session(logdir: Optional[str], name: str = "torch_trace.json"):
    """Device-side profile beside the host trace: runs the block under
    ``torch.profiler.profile`` (CPU activities, plus CUDA when a card is
    present) and, on exit, exports the profiler's own Chrome trace to
    ``logdir/name`` (``logdir=None``: no file). Yields the profiler, so the
    caller can read its events after the block. With
    ``Telemetry(annotate=True)`` the span names appear in that trace as
    ``record_function`` ranges, linking the two timelines. The reference
    wraps ``jax.profiler.trace`` here."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, name))
