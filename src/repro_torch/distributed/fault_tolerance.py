"""Fault tolerance and elasticity (``repro/distributed/fault_tolerance.py``).

The control plane a deployment wires to its heartbeat transport, the
reference's own classes with its semantics:

* ``HeartbeatMonitor``: per-host liveness (``dead_hosts(now=)``: no beat
  for ``timeout_s``) and an EWMA of each host's step time; a straggler is
  a host slower than ``straggler_factor`` x the fleet's median EWMA;
* ``ElasticPlan``: the largest runnable (data, model) mesh for the
  surviving chips: the tensor-parallel degree kept, the data degree the
  largest power of two that fits (at most ``max_data``); ``RuntimeError``
  when the TP degree cannot be kept;
* ``FailureInjector``: a deterministic failure schedule {step: [hosts]}.

The Trainer (``train/trainer.py``) consumes them: before each step the
injector's failures go to its elastic restart, after each step every host
is beaten with the step's wall time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class HostState:
    last_beat: float
    step_time_ewma: float = 0.0


class HeartbeatMonitor:
    def __init__(self, hosts: list[str], timeout_s: float = 60.0,
                 straggler_factor: float = 2.0, ewma: float = 0.9):
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.ewma = ewma
        now = time.monotonic()
        self.hosts = {h: HostState(last_beat=now) for h in hosts}

    def beat(self, host: str, step_time_s: float, now: Optional[float] = None):
        st = self.hosts[host]
        st.last_beat = time.monotonic() if now is None else now
        st.step_time_ewma = (step_time_s if st.step_time_ewma == 0.0
                             else self.ewma * st.step_time_ewma
                             + (1 - self.ewma) * step_time_s)

    def dead_hosts(self, now: Optional[float] = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [h for h, st in self.hosts.items() if now - st.last_beat > self.timeout_s]

    def stragglers(self) -> list[str]:
        times = sorted(st.step_time_ewma for st in self.hosts.values()
                       if st.step_time_ewma > 0)
        if not times:
            return []
        median = times[len(times) // 2]
        return [h for h, st in self.hosts.items()
                if st.step_time_ewma > self.straggler_factor * median]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Largest runnable (data, model) mesh for a surviving chip count."""

    data: int
    model: int
    dropped_chips: int

    @staticmethod
    def plan(alive_chips: int, model_parallel: int, max_data: int) -> "ElasticPlan":
        if alive_chips < model_parallel:
            raise RuntimeError(f"cannot keep TP={model_parallel} with {alive_chips} chips")
        data = min(alive_chips // model_parallel, max_data)
        # the largest power of two not past it: the global batch splits
        # cleanly for stable microbatching
        p = 1
        while p * 2 <= data:
            p *= 2
        return ElasticPlan(data=p, model=model_parallel,
                           dropped_chips=alive_chips - p * model_parallel)


class FailureInjector:
    """Deterministic failure schedule for chaos runs: {step: [hosts]}."""

    def __init__(self, schedule: dict[int, list[str]]):
        self.schedule = schedule

    def failures_at(self, step: int) -> list[str]:
        return self.schedule.get(step, [])
