"""Two-phase FCFS scheduler over the block pool (``repro/serve/scheduler.py``
without parking, prefix caching, telemetry or chaos).

* FCFS waiting queue: a request is admitted when a lane is free AND the
  pool can hold its whole prompt (ceil(prompt_len / block_size) blocks).
  The head of the queue is never skipped, so short requests cannot starve
  it.
* Decode growth allocates one block at a time (``ensure_block``). When the
  pool is empty the YOUNGEST running request is preempted: its blocks are
  freed and it goes back to the FRONT of the queue, to be recomputed from
  scratch on re-admission.
* Without an allocator (``ServeConfig(paged=False)``: every lane owns
  max_seq rows of dense storage) admission needs only a free lane and
  nothing is ever preempted.

Counters are plain integers; ``RequestTiming`` keeps the per-request ticks
and wall-clock stamps the engine's TTFT is read from.
"""
from __future__ import annotations

import dataclasses
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
    arrived_s: Optional[float] = None
    first_token_s: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None or self.arrived_s is None:
            return None
        return self.first_token_s - self.arrived_s


class Scheduler:
    def __init__(self, allocator: Optional[BlockAllocator], max_lanes: int,
                 blocks_per_lane: int):
        self.allocator = allocator  # None: no paged state
        self.max_lanes = max_lanes
        self.blocks_per_lane = blocks_per_lane
        self.waiting: deque = deque()
        self.lane_uid: list[Optional[int]] = [None] * max_lanes
        self.admit_order: dict[int, int] = {}  # uid -> admission tick
        self.timing: dict[int, RequestTiming] = {}
        self.tick_now = 0
        # set by the engine: lane index -> Request to requeue on preemption
        self.requeue_cb = None
        self.admitted = self.finished = self.preemptions = self.tokens = 0

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
    def submit(self, req) -> None:
        self.waiting.append(req)
        t = self.timing.setdefault(req.uid, RequestTiming())
        if t.arrived < 0:
            t.arrived = self.tick_now
            t.arrived_s = time.perf_counter()

    def admit(self) -> list[tuple[int, object]]:
        """Admit FCFS while lanes and blocks allow. Returns [(lane, req)]."""
        admissions = []
        for lane in range(self.max_lanes):
            if self.lane_uid[lane] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            if self.allocator is not None:
                need = self.allocator.blocks_for_tokens(max(len(req.prompt), 1))
                if self.allocator.alloc(req.uid, need) is None:
                    break  # FCFS: don't let short requests starve the head
            self.waiting.popleft()
            self.lane_uid[lane] = req.uid
            self.admit_order[req.uid] = self.tick_now
            self.timing[req.uid].admitted = self.tick_now
            self.admitted += 1
            admissions.append((lane, req))
        return admissions

    # -- decode-time growth ---------------------------------------------------
    def ensure_block(self, lane: int, pos: int) -> bool:
        """Guarantee the block covering ``pos`` exists for ``lane``, may
        preempt the youngest request. False if ``lane`` itself was
        preempted (its step must be skipped this tick)."""
        uid = self.lane_uid[lane]
        if self.allocator is None or uid is None:
            return True
        have = len(self.allocator.tables.get(uid, []))
        need_idx = pos // self.allocator.block_size
        while need_idx >= have:
            if self.allocator.alloc(uid, 1) is not None:
                have += 1
                continue
            victim = self._youngest_lane()
            if victim is None:
                return False
            self.preempt(victim)
            if victim == lane:
                return False
        return True

    def _youngest_lane(self) -> Optional[int]:
        running = [(self.admit_order[uid], lane)
                   for lane, uid in enumerate(self.lane_uid) if uid is not None]
        return max(running)[1] if running else None

    def preempt(self, lane: int) -> None:
        """Evict a lane, free its blocks and requeue its request at the
        queue front (recompute on re-admission)."""
        uid = self.lane_uid[lane]
        if uid is None:
            return
        if self.allocator is not None:
            self.allocator.free(uid)
        self.lane_uid[lane] = None
        self.admit_order.pop(uid, None)
        self.timing[uid].preemptions += 1
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

    def note_token(self, uid: int) -> None:
        t = self.timing[uid]
        if t.first_token < 0:
            t.first_token = self.tick_now
            t.first_token_s = time.perf_counter()
        self.tokens += 1

    @property
    def idle(self) -> bool:
        return not self.waiting and all(u is None for u in self.lane_uid)
