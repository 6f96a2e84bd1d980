"""Deterministic serving workloads: seeded Poisson arrival traces and a
tick-domain replay driver (the port's own copy of
``repro/serve/workload.py``, driving the port's engine).

The continuous-batching headline number — ITL p99 under mixed long/short
prompts — needs a workload that is (a) bursty enough to put a long prefill
in front of decoding lanes and (b) exactly reproducible, so the bench can
compare engine configurations on the SAME arrival sequence and the tests
can replay a trace twice and demand identical outputs.

Determinism comes from two choices:

* the trace is generated by a seeded ``numpy`` Generator — arrival gaps
  (Poisson), prompt lengths (uniform over the given mix) and prompt tokens
  are all pure functions of the seed;
* arrivals are defined in TICK domain, not wall clock: a request is
  submitted when the engine's tick counter reaches its arrival tick. Two
  replays of one trace therefore submit at identical engine states no
  matter how fast the host is, and greedy outputs are bit-identical.

Latency is still measured in wall clock, on the bench side: the replay
driver stamps ``perf_counter`` at submit and at every streamed token
(``Request.on_token``), so TTFT/ITL percentiles can be computed for
exactly the replayed requests — immune to scheduler-histogram
contamination from warmup runs sharing the engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.serve.engine import Request


@dataclasses.dataclass(frozen=True)
class TraceItem:
    uid: int
    arrival_tick: int
    prompt: tuple
    max_new_tokens: int


def poisson_trace(
    *,
    seed: int,
    n_requests: int,
    mean_interarrival_ticks: float,
    prompt_lens: tuple,
    vocab_size: int,
    max_new_tokens: int = 8,
    uid_offset: int = 0,
) -> list[TraceItem]:
    """Seeded Poisson-arrival trace with a mixed prompt-length workload.

    Request k arrives ``Poisson(mean_interarrival_ticks)`` ticks after
    request k-1 (request 0 at tick 0); its prompt length is drawn uniformly
    from ``prompt_lens`` — mix short and long entries to reproduce the
    head-of-line-stall regime. ``uid_offset`` lets a warmup replay share
    the engine without colliding uids."""
    rng = np.random.default_rng(seed)
    items: list[TraceItem] = []
    tick = 0
    for k in range(n_requests):
        if k:
            tick += int(rng.poisson(mean_interarrival_ticks))
        plen = int(prompt_lens[int(rng.integers(len(prompt_lens)))])
        prompt = tuple(int(x) for x in rng.integers(3, vocab_size, plen))
        items.append(TraceItem(uid_offset + k, tick, prompt, max_new_tokens))
    return items


def replay_trace(
    engine, trace: list[TraceItem], *, max_ticks: int = 100_000
) -> dict[int, dict]:
    """Drive ``engine`` through ``trace``: submit each request once the
    engine tick reaches its arrival tick, run until drain. Returns
    ``{uid: {"submit_s": t, "tokens": [t, ...]}}`` wall-clock stamps for
    exactly this replay's requests (tokens via ``Request.on_token``). A
    submission the engine rejects (``max_queue``) is not retried: it keeps
    its stamp with no tokens, which ``latency_metrics`` skips, and its
    outcome is the engine's ``outcomes[uid] == "rejected"``, as in the
    reference."""
    stamps: dict[int, dict] = {}

    def on_token(uid: int, tok: int) -> None:
        stamps[uid]["tokens"].append(time.perf_counter())

    pending = sorted(trace, key=lambda it: (it.arrival_tick, it.uid))
    qi = 0
    for _ in range(max_ticks):
        while qi < len(pending) and pending[qi].arrival_tick <= engine._tick:
            it = pending[qi]
            stamps[it.uid] = {"submit_s": time.perf_counter(), "tokens": []}
            engine.submit(Request(
                it.uid, list(it.prompt),
                max_new_tokens=it.max_new_tokens, on_token=on_token,
            ))
            qi += 1
        if qi >= len(pending) and engine.sched.idle:
            break
        engine.tick()
    return stamps


def latency_metrics(
    stamps: dict[int, dict], uids: Optional[set] = None
) -> dict:
    """TTFT / ITL percentiles (seconds) over the stamped requests.
    TTFT = first token minus submit; ITL = consecutive-token gaps of one
    request, pooled across requests (the tail is the stall signature)."""
    ttfts: list[float] = []
    itls: list[float] = []
    for uid, s in stamps.items():
        if uids is not None and uid not in uids:
            continue
        toks = s["tokens"]
        if not toks:
            continue
        ttfts.append(toks[0] - s["submit_s"])
        itls.extend(float(d) for d in np.diff(toks))

    def pct(xs: list[float], p: float) -> Optional[float]:
        return float(np.percentile(xs, p)) if xs else None

    return {
        "ttft_p50_s": pct(ttfts, 50),
        "ttft_p99_s": pct(ttfts, 99),
        "itl_p50_s": pct(itls, 50),
        "itl_p99_s": pct(itls, 99),
        "n_requests": len(ttfts),
        "n_itl": len(itls),
    }
