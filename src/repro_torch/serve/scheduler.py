"""FCFS scheduler over the block pool (``repro/serve/scheduler.py``
without telemetry): two-phase, or chunk-aware continuous batching when the
engine passes ``chunk_tokens > 0``.

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

Counters are plain integers and the latency samples plain lists;
``stats()``'s percentiles are exact order statistics of those samples
(nearest rank), where the reference reports the upper bound of a
histogram bucket. A preempted request's first token after re-admission
counts as neither TTFT nor inter-token latency but as resume TTFT.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serve.paged import ZERO_BLOCK, BlockAllocator


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


def percentile(xs: list, p: float) -> Optional[float]:
    """Nearest-rank percentile: an observed sample, None for no samples."""
    if not xs:
        return None
    ordered = sorted(xs)
    return ordered[max(math.ceil(p / 100 * len(ordered)), 1) - 1]


class Scheduler:
    def __init__(self, allocator: Optional[BlockAllocator], max_lanes: int,
                 blocks_per_lane: int, chunk_tokens: int = 0, max_queue: int = 0):
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
        self.admitted = self.finished = self.preemptions = self.tokens = 0
        self.cow_copies = self.rejected = self.cancelled = self.deadline_expired = 0
        self.ttft_s: list[float] = []
        self.itl_s: list[float] = []
        self.resume_ttft_s: list[float] = []
        self.ttft_warm_s: list[float] = []

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
            self.rejected += 1
            return False
        self.waiting.append(req)
        t = self.timing.setdefault(req.uid, RequestTiming())
        if t.arrived < 0:
            t.arrived = self.tick_now
            t.arrived_s = time.perf_counter()
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
            self.timing[req.uid].admitted = self.tick_now
            self.admitted += 1
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
                self.cow_copies += 1
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
        self.preemptions += 1
        req = self.requeue_cb(lane) if self.requeue_cb else None
        if req is not None:
            self.waiting.appendleft(req)

    def release(self, lane: int) -> None:
        """Normal retirement: free blocks, mark finished."""
        uid = self.lane_uid[lane]
        if uid is None:
            return
        if self.allocator is not None:
            self.allocator.free(uid)
        self.lane_uid[lane] = None
        self.admit_order.pop(uid, None)
        self.timing[uid].finished = self.tick_now
        self.finished += 1

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
            self.cancelled += 1
        elif outcome == "deadline_expired":
            self.deadline_expired += 1

    def mark_prefix_hit(self, uid: int) -> None:
        """Its first token also counts as a warm TTFT."""
        self._warm_uids.add(uid)

    def note_token(self, uid: int) -> None:
        t = self.timing[uid]
        now = time.perf_counter()
        if t.requeued_s is not None:
            # first token after a requeue: neither TTFT nor ITL
            self.resume_ttft_s.append(now - t.requeued_s)
            t.requeued_s = None
            if t.first_token < 0:
                t.first_token = self.tick_now
        elif t.first_token < 0:
            t.first_token = self.tick_now
            t.first_token_s = now
            if t.arrived_s is not None:
                self.ttft_s.append(now - t.arrived_s)
                if uid in self._warm_uids:
                    self.ttft_warm_s.append(now - t.arrived_s)
        elif t.last_token_s is not None:
            self.itl_s.append(now - t.last_token_s)
        self._warm_uids.discard(uid)
        t.last_token_s = now
        t.new_tokens += 1
        self.tokens += 1

    @property
    def idle(self) -> bool:
        return not self.waiting and all(u is None for u in self.lane_uid)

    def stats(self) -> dict:
        out = {"queued": len(self.waiting),
               "active": sum(u is not None for u in self.lane_uid),
               "admitted": self.admitted, "finished": self.finished,
               "preemptions": self.preemptions, "tokens": self.tokens,
               "new_tokens": sum(t.new_tokens for t in self.timing.values()),
               "cow_copies": self.cow_copies, "parked": len(self.parked),
               "rejected": self.rejected, "cancelled": self.cancelled,
               "deadline_expired": self.deadline_expired}
        for name in ("ttft_s", "itl_s", "resume_ttft_s", "ttft_warm_s"):
            out[f"{name}_p50"] = percentile(getattr(self, name), 50)
            out[f"{name}_p99"] = percentile(getattr(self, name), 99)
        if self.allocator is not None:
            out["kv"] = self.allocator.stats()
        return out
