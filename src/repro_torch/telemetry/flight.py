"""Per-request flight recorder: one bounded lifeline per request (the
port's own copy of ``repro/telemetry/flight.py``).

The registry and the tracer only aggregate (histograms, counters, span
buffers): they can tell you the ITL p99 regressed but not *which
request's life* produced the tail. The flight recorder keeps the missing
view: a small, bounded record of every lifecycle event of each request —

    submit          entered the waiting queue (prompt length)
    admit           got a lane (+ lane index, queue ticks)
    prefill_start / prefill_end
                    batched prefill with its padding bucket — the shape
                    that decides which prefill program signature ran
    prefill_chunk   one continuous-batching prompt chunk (chunk index +
                    token range). Chunks of consecutive ticks AND
                    consecutive chunk indices coalesce into one run
                    ({tick0..tick1, chunk0..chunk1, tok0..tok1}) exactly
                    like decode runs — a run break marks a budget stall,
                    a park, or a decode-tick gap
    decode          per-tick decode membership. Consecutive ticks coalesce
                    into one run ({tick0..tick1, pos0..pos1}) at record
                    time, so steady decode costs O(1) memory per request
                    and a scheduling gap (skipped tick) is visible as a
                    run break
    preempt / requeue
                    victim eviction and head-of-queue requeue
    rebase          frozen-mode boundary rebase touched this lane
    prefix_attach   admission attached a cached prefix (shared block and
                    token counts + "full"/"partial" mode) — the shared
                    span never prefills, so no prefill slice precedes it
    cow             copy-on-write broke the sharing of one block before a
                    divergent decode write (src/dst block ids)
    finish          retirement (+ generated token count)

Bounds make it safe to leave on in production:

* at most ``max_requests`` lifelines are retained; a new request beyond
  that evicts the oldest lifeline FIFO (O(1), counted in
  ``flight_requests_evicted_total``);
* each lifeline holds at most ``max_events`` events; extra events are
  dropped and counted (``flight_events_dropped_total``), never grown;
* counter track samples (queue depth, pool occupancy/fragmentation —
  sampled once per engine tick for the trace viewer's counter tracks)
  live in fixed-size deques.

Timestamps share the owning :class:`~repro_torch.telemetry.tracing.Tracer`'s
``perf_counter`` origin so lifelines and host spans line up on one
timeline in the Perfetto export (``telemetry/export.py``).
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Optional


class Lifeline:
    """One request's recorded life: an append-only, bounded event list."""

    __slots__ = ("uid", "events", "dropped")

    def __init__(self, uid: int):
        self.uid = uid
        self.events: list[dict] = []
        self.dropped = 0

    def kinds(self) -> list[str]:
        return [e["kind"] for e in self.events]


class FlightRecorder:
    def __init__(
        self,
        *,
        max_requests: int = 512,
        max_events: int = 256,
        max_counter_samples: int = 8192,
        registry=None,
        origin: Optional[float] = None,
    ):
        self.max_requests = max_requests
        self.max_events = max_events
        self._origin = time.perf_counter() if origin is None else origin
        self._req: OrderedDict[int, Lifeline] = OrderedDict()
        self.counters: dict[str, deque] = {}
        self._counter_maxlen = max_counter_samples
        if registry is not None:
            self._evicted = registry.counter(
                "flight_requests_evicted_total",
                help="lifelines evicted FIFO when max_requests was hit")
            self._dropped = registry.counter(
                "flight_events_dropped_total",
                help="lifeline events dropped at the per-request cap")
            self._events_total = registry.counter(
                "flight_events_total", help="lifeline events recorded")
        else:
            from repro_torch.telemetry.metrics import _NULL_METRIC

            self._evicted = self._dropped = self._events_total = _NULL_METRIC

    # -- recording -------------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._origin

    def _line(self, uid: int) -> Lifeline:
        line = self._req.get(uid)
        if line is None:
            if len(self._req) >= self.max_requests:
                self._req.popitem(last=False)  # FIFO ring: oldest lifeline out
                self._evicted.inc()
            line = self._req[uid] = Lifeline(uid)
        return line

    def record(self, uid: int, kind: str, **data) -> None:
        """Append one lifecycle event. ``decode`` events with a ``tick``
        that extends the previous decode run coalesce in place (O(1))."""
        line = self._line(uid)
        t = self._now()
        if kind == "decode" and line.events:
            last = line.events[-1]
            if (last["kind"] == "decode"
                    and last.get("tick1") == data.get("tick", -2) - 1):
                last["tick1"] = data["tick"]
                last["pos1"] = data.get("pos", last.get("pos1"))
                last["t1"] = t
                last["n"] = last.get("n", 1) + 1
                self._events_total.inc()
                return
        if kind == "prefill_chunk" and line.events:
            last = line.events[-1]
            if (last["kind"] == "prefill_chunk"
                    and last.get("tick1") == data.get("tick", -2) - 1
                    and last.get("chunk1") == data.get("chunk", -2) - 1):
                last["tick1"] = data["tick"]
                last["chunk1"] = data["chunk"]
                last["tok1"] = data.get("tok1", last.get("tok1"))
                last["t1"] = t
                last["n"] = last.get("n", 1) + 1
                self._events_total.inc()
                return
        if len(line.events) >= self.max_events:
            line.dropped += 1
            self._dropped.inc()
            return
        ev = {"t": round(t, 9), "kind": kind}
        if kind == "decode":
            ev.update(
                tick0=data.get("tick"), tick1=data.get("tick"),
                pos0=data.get("pos"), pos1=data.get("pos"),
                t1=round(t, 9), n=1,
            )
        elif kind == "prefill_chunk":
            ev.update(
                tick0=data.get("tick"), tick1=data.get("tick"),
                chunk0=data.get("chunk"), chunk1=data.get("chunk"),
                tok0=data.get("tok0"), tok1=data.get("tok1"),
                lane=data.get("lane"), t1=round(t, 9), n=1,
            )
        elif data:
            ev.update(data)
        line.events.append(ev)
        self._events_total.inc()

    def counter_sample(self, name: str, value: float) -> None:
        """One point of a counter track (pool occupancy, queue depth, ...);
        fixed-size deque, oldest samples roll off silently."""
        dq = self.counters.get(name)
        if dq is None:
            dq = self.counters[name] = deque(maxlen=self._counter_maxlen)
        dq.append((round(self._now(), 9), float(value)))

    # -- reading ---------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return True

    def lifeline(self, uid: int) -> Optional[Lifeline]:
        return self._req.get(uid)

    def lifelines(self) -> list[Lifeline]:
        return list(self._req.values())

    def summary(self) -> dict:
        return {
            "requests": len(self._req),
            "events": int(self._events_total.value),
            "dropped_events": int(self._dropped.value),
            "evicted_requests": int(self._evicted.value),
        }

    def dump_jsonl(self, fh) -> int:
        """One ``{"kind": "flight", "uid": ..., "events": [...]}`` line per
        retained lifeline; returns lines written."""
        import json

        n = 0
        for line in self._req.values():
            fh.write(json.dumps({
                "kind": "flight", "uid": line.uid,
                "dropped": line.dropped, "events": line.events,
            }) + "\n")
            n += 1
        return n


class NullFlightRecorder:
    """Disabled twin: records nothing, retains nothing."""

    enabled = False
    counters: dict = {}

    def record(self, uid: int, kind: str, **data) -> None:
        pass

    def counter_sample(self, name: str, value: float) -> None:
        pass

    def lifeline(self, uid: int):
        return None

    def lifelines(self) -> list:
        return []

    def summary(self) -> dict:
        return {"requests": 0, "events": 0, "dropped_events": 0,
                "evicted_requests": 0}

    def dump_jsonl(self, fh) -> int:
        return 0
