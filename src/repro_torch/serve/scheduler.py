"""FCFS scheduler over the block pool (``repro/serve/scheduler.py``):
two-phase, or chunk-aware continuous batching when the engine passes
``chunk_tokens > 0``.

* FCFS waiting queue: a request is admitted when a lane is free AND the
  pool can cover its admission need: the whole prompt (ceil(prompt_len /
  block_size) blocks) in two-phase mode, only its first chunk in chunked
  mode (later chunks grow through ``ensure_prefill_blocks``, which never
  preempts: a starved chunk stalls a tick instead of evicting a decoding
  lane), and only the uncached tail when ``prefix_probe`` says a cached
  prefix covers the rest. The head of the queue is never skipped.
* Decode growth allocates one block at a time (``ensure_block``). When the
  pool is empty it first reclaims the oldest PARKED request's blocks, then
  preempts the YOUNGEST running request: its blocks are freed and it goes
  back to the FRONT of the queue, to be recomputed on re-admission. A
  victim caught mid-chunked-prefill is parked instead when the engine's
  ``park_cb`` claims it (its blocks stay allocated, re-admission resumes
  at the completed-chunk boundary). A write into a shared block (refcount
  > 1) first copies it (``BlockAllocator.cow`` + ``cow_cb``).
* Without an allocator (``ServeConfig(paged=False)``: every lane owns
  max_seq rows of dense storage) admission needs only a free lane and
  nothing is ever preempted.
* ``max_queue > 0`` bounds the waiting queue: ``submit`` past it returns
  False and records nothing but the rejection. ``remove_waiting``,
  ``discard`` and ``mark_terminal`` end a request early (cancellation,
  deadline) without the normal-finish accounting.
* The chaos ``admission_stall`` site (``chaos``, set by the engine) makes
  ``admit`` admit nothing for the tick.

Counters and latency samples live in a metrics registry that is always
real (the engine's when telemetry is on, else the scheduler's own), so
``stats()`` is the reference's view over the same histograms: tick
percentiles from unit buckets (exact up to 64 ticks), seconds
percentiles as the upper bound of the bucket holding the rank. A
preempted request's first token after re-admission counts as neither
TTFT nor inter-token latency but as resume TTFT. ``flight`` (a flight
recorder; a no-op one by default) gets the queue-side lifecycle events
(submit, reject, admit, cow, park_drop, preempt, requeue, finish, cancel,
deadline) at the reference's call points.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serve.paged import ZERO_BLOCK, BlockAllocator
from repro_torch.telemetry.flight import NullFlightRecorder
from repro_torch.telemetry.metrics import (LATENCY_BUCKETS, TICK_BUCKETS,
                                           MetricsRegistry)


@dataclasses.dataclass
class RequestTiming:
    arrived: int = -1
    admitted: int = -1
    first_token: int = -1
    finished: int = -1
    preemptions: int = 0
    new_tokens: int = 0
    arrived_s: Optional[float] = None
    first_token_s: Optional[float] = None
    last_token_s: Optional[float] = None
    # set on preemption, cleared by the first post-resume token
    requeued_s: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None or self.arrived_s is None:
            return None
        return self.first_token_s - self.arrived_s


class Scheduler:
    def __init__(self, allocator: Optional[BlockAllocator], max_lanes: int,
                 blocks_per_lane: int, registry: Optional[MetricsRegistry] = None,
                 flight=None, chunk_tokens: int = 0, max_queue: int = 0):
        self.allocator = allocator  # None: no paged state
        self.max_lanes = max_lanes
        self.blocks_per_lane = blocks_per_lane
        self.chunk_tokens = chunk_tokens
        self.max_queue = max_queue  # 0: unbounded
        self.chaos = None
        self.waiting: deque = deque()
        # uids parked mid-chunked-prefill, blocks kept (oldest first)
        self.parked: dict[int, int] = {}
        self.lane_uid: list[Optional[int]] = [None] * max_lanes
        self.admit_order: dict[int, int] = {}  # uid -> admission tick
        self.timing: dict[int, RequestTiming] = {}
        self.tick_now = 0
        # engine hooks: requeue_cb(lane) -> Request; park_cb(lane) -> bool
        # (True: parked, keep its blocks); park_drop_cb(uid) when a parked
        # request's blocks are reclaimed; prefix_probe(req) -> leading
        # tokens a cached prefix covers; cow_cb(old, new) device block copy
        self.requeue_cb = self.park_cb = self.park_drop_cb = None
        self.prefix_probe = self.cow_cb = None
        self._warm_uids: set = set()
        self.flight = flight if flight is not None else NullFlightRecorder()
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._admitted = r.counter("serve_admitted_total", help="requests admitted to a lane")
        self._finished = r.counter("serve_finished_total", help="requests retired normally")
        self._preempted = r.counter("serve_preempted_total", help="preemptions (youngest-victim)")
        self._requeued = r.counter("serve_requeued_total",
                                   help="preempted requests requeued at the head")
        self._tokens = r.counter("serve_tokens_total",
                                 help="decode tokens emitted (recounts recomputed tokens)")
        r.gauge("serve_queue_depth", help="requests waiting for a lane",
                fn=lambda: float(len(self.waiting)))
        r.gauge("serve_active_lanes", help="lanes holding a request",
                fn=lambda: float(sum(u is not None for u in self.lane_uid)))
        self._ttft_ticks = r.histogram(
            "serve_ttft_ticks", help="engine ticks from arrival to first token",
            buckets=TICK_BUCKETS)
        self._latency_ticks = r.histogram(
            "serve_latency_ticks", help="engine ticks from arrival to finish",
            buckets=TICK_BUCKETS)
        self._ttft_s = r.histogram(
            "serve_ttft_seconds", help="wall seconds from arrival to first token",
            buckets=LATENCY_BUCKETS)
        self._itl_s = r.histogram(
            "serve_itl_seconds",
            help="wall seconds between consecutive tokens of one request",
            buckets=LATENCY_BUCKETS)
        self._resume_ttft_s = r.histogram(
            "serve_resume_ttft_seconds",
            help="wall seconds from requeue to the first post-resume token "
                 "(kept out of both ttft and itl)",
            buckets=LATENCY_BUCKETS)
        self._warm_ttft_s = r.histogram(
            "serve_ttft_warm_seconds",
            help="wall seconds from arrival to first token for requests "
                 "admitted onto a cached prefix (also counted in "
                 "serve_ttft_seconds)",
            buckets=LATENCY_BUCKETS)
        self._cow_copies = r.counter(
            "prefix_cow_copies_total", help="shared blocks copied on first divergent write")
        self._rejected = r.counter(
            "serve_rejected_total", help="submissions refused by the max_queue admission bound")
        self._cancelled = r.counter(
            "serve_cancelled_total", help="requests terminated by client cancellation")
        self._deadline_expired = r.counter(
            "serve_deadline_expired_total",
            help="requests terminated by their deadline_ticks budget")

    @property
    def total_preemptions(self) -> int:
        return int(self._preempted.value)

    @property
    def total_admitted(self) -> int:
        return int(self._admitted.value)

    @property
    def total_finished(self) -> int:
        return int(self._finished.value)

    # -- block tables ---------------------------------------------------------
    def table_row(self, lane: int) -> np.ndarray:
        """One lane's block table, ZERO_BLOCK-padded to blocks_per_lane."""
        row = np.full(self.blocks_per_lane, ZERO_BLOCK, np.int32)
        uid = self.lane_uid[lane]
        if self.allocator is not None and uid is not None:
            blocks = self.allocator.tables.get(uid, [])
            row[: len(blocks)] = blocks
        return row

    def tables(self) -> np.ndarray:
        """(max_lanes, blocks_per_lane) int32 block tables."""
        return np.stack([self.table_row(lane) for lane in range(self.max_lanes)])

    # -- queue ----------------------------------------------------------------
    def submit(self, req) -> bool:
        """Queue a request; False (no timing entry made) when the
        ``max_queue`` bound rejects it."""
        if self.max_queue > 0 and len(self.waiting) >= self.max_queue:
            self._rejected.inc()
            self.flight.record(req.uid, "reject", tick=self.tick_now,
                               queue_depth=len(self.waiting),
                               retry_after_ticks=max(1, len(self.waiting)))
            return False
        self.waiting.append(req)
        t = self.timing.setdefault(req.uid, RequestTiming())
        if t.arrived < 0:
            t.arrived = self.tick_now
            t.arrived_s = time.perf_counter()
            self.flight.record(req.uid, "submit", prompt_len=len(req.prompt),
                               tick=self.tick_now)
        return True

    def _blocks_for_prompt(self, req) -> int:
        if self.allocator is None or req.uid in self.parked:
            return 0  # a parked request still holds its committed chunks
        n = max(len(req.prompt), 1)
        if self.prefix_probe is not None:
            # a cached prefix is resident already: charge the tail only
            shared = int(self.prefix_probe(req))
            if shared >= len(req.prompt):
                return 0
            if shared:
                tail = len(req.prompt) - shared
                if self.chunk_tokens > 0:
                    tail = min(tail, self.chunk_tokens)
                return self.allocator.blocks_for_tokens(tail)
        if self.chunk_tokens > 0:
            n = min(n, self.chunk_tokens)
        return self.allocator.blocks_for_tokens(n)

    def admit(self) -> list[tuple[int, object]]:
        """Admit FCFS while lanes and blocks allow. Returns [(lane, req)]."""
        if self.chaos is not None and self.chaos.fire("admission_stall"):
            return []
        admissions = []
        for lane in range(self.max_lanes):
            if self.lane_uid[lane] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            need = self._blocks_for_prompt(req)
            if self.allocator is not None:
                if not self.allocator.can_alloc(need):
                    break  # FCFS: don't let short requests starve the head
                if need and self.allocator.alloc(req.uid, need) is None:
                    # can_alloc promised room but the allocation came up
                    # short (an injected alloc_fail, or an eviction sweep
                    # that freed less): stall rather than seat it blockless
                    break
            self.parked.pop(req.uid, None)
            self.waiting.popleft()
            self.lane_uid[lane] = req.uid
            self.admit_order[req.uid] = self.tick_now
            t = self.timing[req.uid]
            t.admitted = self.tick_now
            self._admitted.inc()
            self.flight.record(req.uid, "admit", lane=lane, tick=self.tick_now,
                               queued_ticks=self.tick_now - t.arrived)
            admissions.append((lane, req))
        return admissions

    # -- growth ---------------------------------------------------------------
    def _make_room(self, lane: int) -> bool:
        """One rung of the pressure ladder: reclaim a parked request, else
        preempt the youngest lane. False if ``lane`` itself was the victim
        or nothing could be freed."""
        if self.reclaim_parked():
            return True
        victim = self._youngest_lane()
        if victim is None:
            return False
        self.preempt(victim)
        return victim != lane

    def ensure_block(self, lane: int, pos: int) -> bool:
        """Guarantee ``lane`` owns, unshared, the block covering ``pos``;
        may reclaim parked blocks and preempt the youngest request. False
        if ``lane`` itself was preempted (its step must be skipped)."""
        uid = self.lane_uid[lane]
        if self.allocator is None or uid is None:
            return True
        need_idx = pos // self.allocator.block_size
        while need_idx >= len(self.allocator.tables.get(uid, [])):
            if self.allocator.alloc(uid, 1) is None and not self._make_room(lane):
                return False
        # a shared block (the partial last block of an attached prefix):
        # break the sharing before this lane's first write into it
        while self.allocator.refcount(self.allocator.tables[uid][need_idx]) > 1:
            got = self.allocator.cow(uid, need_idx)
            if got is not None:
                if self.cow_cb is not None:
                    self.cow_cb(*got)
                self._cow_copies.inc()
                self.flight.record(uid, "cow", tick=self.tick_now, src=got[0], dst=got[1])
                break
            if not self._make_room(lane):
                return False
        return True

    def ensure_prefill_blocks(self, lane: int, n_tokens: int) -> bool:
        """Grow ``lane``'s table to cover ``n_tokens`` prompt tokens for its
        next chunk. Never preempts (decode lanes do not die for a prompt):
        reclaims parked blocks, else stalls (False) until retirements free
        blocks."""
        uid = self.lane_uid[lane]
        if self.allocator is None or uid is None:
            return True
        need = self.allocator.blocks_for_tokens(n_tokens)
        while len(self.allocator.tables.get(uid, [])) < need:
            short = need - len(self.allocator.tables.get(uid, []))
            if self.allocator.alloc(uid, short) is not None:
                return True
            if not self.reclaim_parked():
                return False
        return True

    def reclaim_parked(self) -> bool:
        """Free the OLDEST parked request's blocks and drop its resume
        state (it recomputes on re-admission). True if blocks were freed."""
        if not self.parked:
            return False
        uid = next(iter(self.parked))
        del self.parked[uid]
        self.allocator.free(uid)
        if self.park_drop_cb is not None:
            self.park_drop_cb(uid)
        self.flight.record(uid, "park_drop", tick=self.tick_now)
        return True

    def _youngest_lane(self) -> Optional[int]:
        running = [(self.admit_order[uid], lane)
                   for lane, uid in enumerate(self.lane_uid) if uid is not None]
        return max(running)[1] if running else None

    def preempt(self, lane: int) -> None:
        """Evict a lane and requeue its request at the queue front: parked
        (blocks kept) if ``park_cb`` claims it, else its blocks are freed
        and it recomputes on re-admission."""
        uid = self.lane_uid[lane]
        if uid is None:
            return
        parked = bool(self.park_cb(lane)) if self.park_cb is not None else False
        if parked:
            self.parked[uid] = self.tick_now
        elif self.allocator is not None:
            self.allocator.free(uid)
        self.lane_uid[lane] = None
        self.admit_order.pop(uid, None)
        t = self.timing[uid]
        t.preemptions += 1
        # tokens so far are recomputed and recounted; first_token stands
        t.new_tokens = 0
        t.last_token_s = None
        t.requeued_s = time.perf_counter()
        self._preempted.inc()
        self.flight.record(uid, "preempt", lane=lane, tick=self.tick_now, parked=parked)
        req = self.requeue_cb(lane) if self.requeue_cb else None
        if req is not None:
            self.waiting.appendleft(req)
            self._requeued.inc()
            self.flight.record(uid, "requeue", tick=self.tick_now)

    def release(self, lane: int) -> None:
        """Normal retirement: free blocks, mark finished."""
        uid = self.lane_uid[lane]
        if uid is None:
            return
        if self.allocator is not None:
            self.allocator.free(uid)
        self.lane_uid[lane] = None
        self.admit_order.pop(uid, None)
        t = self.timing[uid]
        t.finished = self.tick_now
        self._finished.inc()
        self._latency_ticks.observe(t.finished - t.arrived)
        self.flight.record(uid, "finish", tick=self.tick_now, tokens=t.new_tokens,
                           latency_ticks=t.finished - t.arrived)

    def remove_waiting(self, uid: int):
        """Take a queued (not admitted) request out of the queue: the
        Request, or None if ``uid`` is not queued."""
        for req in self.waiting:
            if req.uid == uid:
                self.waiting.remove(req)
                return req
        return None

    def discard(self, lane: int, outcome: str) -> None:
        """End a seated lane without the normal-finish accounting: free its
        blocks, clear the seat, record ``outcome``."""
        uid = self.lane_uid[lane]
        if uid is None:
            return
        if self.allocator is not None:
            self.allocator.free(uid)
        self.lane_uid[lane] = None
        self.admit_order.pop(uid, None)
        self.mark_terminal(uid, outcome)

    def mark_terminal(self, uid: int, outcome: str) -> None:
        """Count a ``cancelled`` / ``deadline_expired`` end and stamp its
        tick as the request's finish."""
        t = self.timing.get(uid)
        if t is not None:
            t.finished = self.tick_now
        if outcome == "cancelled":
            self._cancelled.inc()
            self.flight.record(uid, "cancel", tick=self.tick_now)
        elif outcome == "deadline_expired":
            self._deadline_expired.inc()
            self.flight.record(uid, "deadline", tick=self.tick_now)

    def mark_prefix_hit(self, uid: int) -> None:
        """Its first token also counts as a warm TTFT."""
        self._warm_uids.add(uid)

    def note_token(self, uid: int) -> None:
        t = self.timing[uid]
        now = time.perf_counter()
        if t.requeued_s is not None:
            # first token after a requeue: neither TTFT nor ITL
            self._resume_ttft_s.observe(now - t.requeued_s)
            t.requeued_s = None
            if t.first_token < 0:
                t.first_token = self.tick_now
        elif t.first_token < 0:
            t.first_token = self.tick_now
            t.first_token_s = now
            self._ttft_ticks.observe(t.first_token - t.arrived)
            if t.arrived_s is not None:
                self._ttft_s.observe(now - t.arrived_s)
                if uid in self._warm_uids:
                    self._warm_ttft_s.observe(now - t.arrived_s)
        elif t.last_token_s is not None:
            self._itl_s.observe(now - t.last_token_s)
        self._warm_uids.discard(uid)  # one-shot
        t.last_token_s = now
        t.new_tokens += 1
        self._tokens.inc()

    @property
    def idle(self) -> bool:
        return not self.waiting and all(u is None for u in self.lane_uid)

    def stats(self) -> dict:
        """The reference's view over the registry (plus live queue and lane
        state); every percentile is None until its first observation."""
        th, lh = self._ttft_ticks, self._latency_ticks
        out = {
            "queued": len(self.waiting),
            "active": sum(u is not None for u in self.lane_uid),
            "admitted": self.total_admitted,
            "finished": self.total_finished,
            "preemptions": self.total_preemptions,
            "new_tokens": sum(t.new_tokens for t in self.timing.values()),
            "ttft_ticks_p50": th.percentile(50),
            "ttft_ticks_p90": th.percentile(90),
            "ttft_ticks_p99": th.percentile(99),
            "latency_ticks_p50": lh.percentile(50),
            "latency_ticks_p90": lh.percentile(90),
            "latency_ticks_p99": lh.percentile(99),
            "ttft_s_p50": self._ttft_s.percentile(50),
            "ttft_s_p99": self._ttft_s.percentile(99),
            "itl_s_p50": self._itl_s.percentile(50),
            "itl_s_p99": self._itl_s.percentile(99),
            "resume_ttft_s_p50": self._resume_ttft_s.percentile(50),
            "resume_ttft_s_p99": self._resume_ttft_s.percentile(99),
            "ttft_warm_s_p50": self._warm_ttft_s.percentile(50),
            "ttft_warm_s_p99": self._warm_ttft_s.percentile(99),
            "cow_copies": int(self._cow_copies.value),
            "parked": len(self.parked),
            "rejected": int(self._rejected.value),
            "cancelled": int(self._cancelled.value),
            "deadline_expired": int(self._deadline_expired.value),
        }
        if self.allocator is not None:
            out["kv"] = self.allocator.stats()
        return out
