"""Deterministic chaos harness for the serving engine (the port's own copy
of ``repro/serve/chaos.py``).

A ``FaultPlan`` is a seed plus a set of ``FaultRule``s, each naming an
injection *site* threaded through the engine:

========== ====================================================================
site        effect
========== ====================================================================
alloc_fail       ``BlockAllocator._take_free`` returns None (allocation
                 shortfall) even when blocks are free: admission backoff,
                 ``ensure_block`` preemption, chunk stalls.
fragment         the allocator's free list is deterministically shuffled,
                 destroying LIFO locality: the regime ``defragment`` is for.
tick_delay       the engine sleeps ``param`` seconds (default 1 ms) at the
                 top of the tick (deadlines are tick-domain, so outputs are
                 unaffected).
drop_sample      a sampled token is discarded before commit; the lane is
                 replay-preempted (the per-tick landmark-sum updates make
                 an in-place retry unsound, so recovery is a full
                 recompute).
nan_stats        the lane's streaming landmark ``(m, l, acc)`` rows are set
                 to NaN after the decode dispatch: the silent corruption
                 the numerics guard exists for.
nan_logits       the lane's sampled logits row is set to NaN on the host:
                 forces the guard's replay-preempt rung.
admission_stall  ``Scheduler.admit`` admits nothing this tick: queue
                 growth, backpressure, the watchdog.
hash_collision   prefix-cache lookups perturb their block digests, forcing
                 a cold miss (lost reuse, never lost correctness).
evict_storm      ``param`` (default 4) prefix-cache entries are evicted at
                 the top of the tick: pin accounting and re-insertion.
========== ====================================================================

Every firing decision derives from ``(plan.seed, site, tick, ordinal,
lane)`` through a fresh numpy Philox stream, the same stream as the
reference's, so a plan fires on the same opportunities in both engines
and a failing seed replays exactly. ``injections`` counts every firing,
``by_site`` per site. Each firing is also a flight-recorder ``chaos``
event (uid -1) and counts in ``chaos_injections_total{site=}``: the
engine passes its scheduler's flight recorder and registry.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np

SITES = (
    "alloc_fail",
    "fragment",
    "tick_delay",
    "drop_sample",
    "nan_stats",
    "nan_logits",
    "admission_stall",
    "hash_collision",
    "evict_storm",
)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection site with an optional tick window / lane / rate.

    ``rate`` is the per-opportunity firing probability (1.0 = always).
    ``start_tick``/``end_tick`` bound the window (end 0 = open-ended).
    ``lane`` restricts lane-scoped sites to one lane (-1 = any).
    ``param`` is site-specific: sleep seconds for tick_delay, eviction
    count for evict_storm.
    """

    site: str
    rate: float = 1.0
    start_tick: int = 0
    end_tick: int = 0
    lane: int = -1
    param: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown chaos site {self.site!r}; "
                             f"known: {', '.join(SITES)}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus the rules it drives. Hashable, printable, replayable."""

    seed: int = 0
    rules: tuple[FaultRule, ...] = ()

    def sites(self) -> set[str]:
        return {r.site for r in self.rules}


class EngineStalled(RuntimeError):
    """Raised by the no-progress watchdog after its ladder (reclaim parked,
    then preempt the youngest lane) fails to restore progress; carries the
    state of the wedge."""

    def __init__(self, tick: int, stall_ticks: int, waiting: int,
                 active_lanes: int, parked: int, pool: dict):
        self.tick = tick
        self.stall_ticks = stall_ticks
        self.waiting = waiting
        self.active_lanes = active_lanes
        self.parked = parked
        self.pool = pool
        super().__init__(
            f"engine made no progress for {stall_ticks} ticks at tick "
            f"{tick} (waiting={waiting} active_lanes={active_lanes} "
            f"parked={parked} pool={pool})"
        )


class ChaosInjector:
    """Evaluates a FaultPlan at each hook point, deterministically.

    ``fire(site, lane)`` returns the matching FaultRule if the injection
    fires this call, else None. Calls to one site within a tick get
    distinct ordinals, so ``rate`` applies per opportunity and the whole
    schedule still replays from ``(seed, tick)``.
    """

    def __init__(self, plan: FaultPlan, flight=None, registry=None):
        self.plan = plan
        self.flight = flight
        self.tick = 0
        self._ordinals: dict[str, int] = {}
        self._by_site: dict[str, list[FaultRule]] = {}
        for r in plan.rules:
            self._by_site.setdefault(r.site, []).append(r)
        self.injections = 0
        self.by_site: dict[str, int] = {}
        self._counter = None
        if registry is not None:
            self._counter = registry.counter(
                "chaos_injections_total",
                help="fault injections fired by the chaos harness",
                labels=("site",),
            )

    def begin_tick(self, tick: int):
        self.tick = tick
        self._ordinals.clear()

    def fire(self, site: str, lane: Optional[int] = None,
             detail: str = "") -> Optional[FaultRule]:
        rules = self._by_site.get(site)
        if not rules:
            return None
        ordinal = self._ordinals.get(site, 0)
        self._ordinals[site] = ordinal + 1
        for rule in rules:
            if self.tick < rule.start_tick:
                continue
            if rule.end_tick and self.tick > rule.end_tick:
                continue
            if rule.lane >= 0 and lane is not None and lane != rule.lane:
                continue
            if rule.rate < 1.0:
                # SeedSequence entropy must be non-negative ints; lane -1
                # (site not lane-scoped) maps to 0.
                rng = np.random.default_rng([
                    self.plan.seed,
                    zlib.crc32(site.encode()),
                    self.tick,
                    ordinal,
                    (lane if lane is not None else -1) + 1,
                ])
                if rng.random() >= rule.rate:
                    continue
            self.injections += 1
            self.by_site[site] = self.by_site.get(site, 0) + 1
            if self._counter is not None:
                self._counter.labels(site=site).inc()
            if self.flight is not None:
                self.flight.record(
                    -1, "chaos", tick=self.tick, site=site,
                    lane=-1 if lane is None else lane, ordinal=ordinal,
                    detail=detail,
                )
            return rule
        return None
