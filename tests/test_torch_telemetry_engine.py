"""Telemetry wired into the port (scheduler, prefix cache, chaos injector,
engine, trainer, launcher) against the JAX reference with telemetry on,
on the CPU.

* The scheduler's registry (the repair of its stats view): ``stats()``
  has the reference's keys, its tick percentiles come from the same
  unit-bucket histograms, and the same calls give the same values.
* ``PrefixCache(registry=)`` and the chaos injector's flight events and
  ``chaos_injections_total``, driven through the same calls as the
  reference's.
* Four serving routes on reduced Qwen2-7B with the reference's own
  weights, each run once per engine and side: two-phase exact streaming
  on a pool that preempts, with the numerics probe every 2 ticks; frozen
  streaming on the gather route (boundary rebases, the drift probe);
  the chunked tick with the prefix cache, requests one at a time (hits,
  a miss, copy-on-write, evictions); and the chaos soak's settings under
  every plan's rules but ``tick_delay`` at seed 0. Greedy tokens, every
  flight lifeline (kinds and data, timestamps aside), the deterministic
  counters, the tick histograms, the span names per tick, the
  scheduler's tick percentiles and the drift residuals equal the JAX
  engine's; ``program_shapes`` equals the JAX engine's ``xla_compiles``
  program by program, apart from the paged decode tick (named below),
  and stays flat when the same requests run again.
* Telemetry off: the same tokens, the null registry, no ``stats()`` key.
* Reduced DeepSeek-V2-Lite (family ``moe``) serves with telemetry on, its
  tokens those of telemetry off; the trainer's three CPU steps with a
  ``Telemetry``; the launcher's ``--metrics-out``; an annotated engine
  run under ``torch.profiler``.

The reference's core metric families (``tests/test_telemetry.py:308``)
include ``autotune_plan_resolutions_total``, which the engine's plan
warm-up counts through ``kernels/dispatch.py``; the port's contract is
the same list (its values against the JAX engine's:
``tests/test_torch_dispatch.py``).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models.model import model_specs as jmodel_specs  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.serve import chaos as jchaos  # noqa: E402
from repro.serve import paged as jpaged  # noqa: E402
from repro.serve import workload as jworkload  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro.telemetry import FlightRecorder as JFlightRecorder  # noqa: E402
from repro.telemetry import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro_torch import telemetry as tel  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.serve import random_params  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serve import chaos, paged, workload  # noqa: E402
from repro_torch.serve.engine import PROGRAMS, Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import Scheduler  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

CORE_FAMILIES = (
    "serve_ttft_ticks", "serve_latency_ticks", "serve_ttft_seconds",
    "serve_itl_seconds", "serve_admitted_total", "serve_tokens_total",
    "serve_ticks_total", "serve_rebases_total", "span_seconds",
    "pool_utilization", "pool_fragmentation", "autotune_plan_resolutions_total",
    "drift_rebase_residual", "spectrum_mass_top1_ema",
)
# counters and tick-valued histograms that must equal the JAX engine's
# (wall-clock families excepted; the monitors' floats are held apart)
DETERMINISTIC = (
    "serve_ticks_total", "serve_rebases_total", "serve_admitted_total",
    "serve_tokens_total", "serve_finished_total", "serve_preempted_total",
    "serve_requeued_total", "serve_rejected_total", "serve_cancelled_total",
    "serve_deadline_expired_total", "prefix_cache_hits_total",
    "prefix_cache_misses_total", "prefix_cache_evictions_total",
    "prefix_cow_copies_total", "prefix_hit_blocks", "chaos_injections_total",
    "serve_ttft_ticks", "serve_latency_ticks", "serve_recovery_ticks",
    "serve_watchdog_fires_total", "numerics_quarantines_total",
    "numerics_demotions_total", "numerics_checks_total", "numerics_nonfinite_total",
    "flight_events_total", "flight_events_dropped_total",
    "flight_requests_evicted_total", "spectrum_observations_total",
    "serve_queue_depth", "serve_active_lanes", "pool_blocks_used", "pool_blocks_free",
    "pool_utilization", "pool_fragmentation",
)
MONITORS = ("spectrum_mass_top1_ema", "spectrum_eff_landmark_frac_ema",
            "drift_rebase_residual_last")
SIDES = {"port": (ServeEngine, Request, chaos, workload),
         "jax": (JServeEngine, JRequest, jchaos, jworkload)}

PAGED = dict(max_lanes=3, max_seq=96, block_size=8, prefill_impl="ss_fused",
             decode_impl="paged")
SOAK = dict(max_lanes=2, max_seq=64, block_size=8, prefix_cache=True, chunked_prefill=True,
            watchdog_ticks=16)
# every rule of the chaos soak's four plans but tick_delay (a wall-clock sleep)
CHAOS_RULES = (("alloc_fail", dict(rate=0.15)), ("fragment", dict(rate=0.5)),
               ("admission_stall", dict(start_tick=3, end_tick=10)),
               ("drop_sample", dict(rate=0.1)), ("hash_collision", dict(rate=0.5)),
               ("evict_storm", dict(rate=0.25, param=2)))
# route -> (ServeConfig fields, ModelConfig fields, requests)
ROUTES = {
    "two_phase_exact": (dict(PAGED, num_blocks=12, numerics_probe_every=2),
                        dict(decode_streaming="exact"), "batch"),
    "frozen_gather": (dict(PAGED, decode_impl="gather", numerics_probe_every=3),
                      dict(decode_streaming="frozen"), "batch"),
    "chunked_prefix": (dict(PAGED, max_lanes=2, chunked_prefill=True, prefill_chunk_tokens=16,
                            prefix_cache=True, prefix_cache_blocks=10),
                       dict(decode_streaming="exact"), "one_at_a_time"),
    "chaos_seed0": (SOAK, {}, "trace"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread per test worker: the engines run many small ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jbase.reduced(jget_config("qwen2-7b")), capacity_factor=100.0)
    cfg = dataclasses.replace(base.reduced(get_config("qwen2-7b")), capacity_factor=100.0)
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(0))
    return {"jax": (jcfg, jparams),
            "port": (cfg, params_from_numpy(jax.tree.map(np.asarray, jparams)))}


def _engine(weights, side, route, **serve_kw):
    serve_fields, model_fields, _ = ROUTES[route]
    eng_cls, _, chaos_mod, _ = SIDES[side]
    cfg, params = weights[side]
    cfg = dataclasses.replace(cfg, **model_fields)
    serve = (base if side == "port" else jbase).ServeConfig(
        **dict(serve_fields, telemetry=True, **serve_kw))
    plan = None
    if route == "chaos_seed0":
        plan = chaos_mod.FaultPlan(seed=0, rules=tuple(chaos_mod.FaultRule(s, **kw)
                                                       for s, kw in CHAOS_RULES))
    kw = dict(device="cpu") if side == "port" else {}
    return eng_cls(cfg, params, serve=serve, chaos=plan, **kw)


def _drive(eng, side, route, uid0=0):
    """Feed the route's requests (uids from ``uid0``) and run to drain."""
    req_cls, wl = SIDES[side][1], SIDES[side][3]
    vocab = eng.cfg.vocab_size
    kind = ROUTES[route][2]
    rng = np.random.default_rng(0)
    if kind == "batch":
        for k, n in enumerate((10, 29, 45, 32)):
            eng.submit(req_cls(uid0 + k, rng.integers(3, vocab, n).tolist(),
                               max_new_tokens=10))
        eng.run()
    elif kind == "one_at_a_time":
        a = rng.integers(3, vocab, 40).tolist()
        b = a[:24] + rng.integers(3, vocab, 13).tolist()
        c = rng.integers(3, vocab, 29).tolist()
        for k, prompt in enumerate((a, a, b, c, c)):
            eng.submit(req_cls(uid0 + k, list(prompt), max_new_tokens=6))
            eng.run()
    else:
        trace = wl.poisson_trace(seed=0, n_requests=6, mean_interarrival_ticks=2,
                                 prompt_lens=(5, 12, 21), vocab_size=vocab,
                                 max_new_tokens=6, uid_offset=uid0)
        wl.replay_trace(eng, trace, max_ticks=1500)
    assert eng.sched.idle


def _ticks(tracer) -> list:
    """Span (name, depth, labels) per engine tick: events record at exit,
    so a tick's spans precede its ``serve_tick``."""
    out, cur = [], []
    for e in tracer.events:
        cur.append((e["name"], e["depth"], e.get("labels")))
        if e["name"] == "serve_tick":
            out.append(cur)
            cur = []
    return out


def _lifelines(flight) -> dict:
    return {ln.uid: ([{k: v for k, v in e.items() if k not in ("t", "t1")}
                      for e in ln.events], ln.dropped) for ln in flight.lifelines()}


_RUNS: dict = {}


def _route(weights, route, side) -> dict:
    """One telemetry-on run of ``route`` on ``side``, cached per module."""
    key = (route, side)
    if key in _RUNS:
        return _RUNS[key]
    eng = _engine(weights, side, route)
    drift = []
    if eng._drift_mon is not None:
        observe = eng._drift_mon.observe
        eng._drift_mon.observe = lambda r: (drift.append(r), observe(r))
    _drive(eng, side, route)
    snap = eng.telemetry.metrics.snapshot()
    st = eng.stats()
    run = dict(outputs=dict(eng.finished), outcomes=dict(eng.outcomes), snap=snap,
               lifelines=_lifelines(eng.telemetry.flight), ticks=_ticks(eng.telemetry.tracer),
               sched=eng.sched.stats(), stats=st, drift=list(drift),
               shapes=st["program_shapes" if side == "port" else "xla_compiles"])
    if side == "port":
        # the same requests again: every signature was seen
        _drive(eng, side, route, uid0=100)
        run["shapes_again"] = eng.stats()["program_shapes"]
        run["engine"] = eng
    _RUNS[key] = run
    return run


def _both(weights, route):
    return _route(weights, route, "port"), _route(weights, route, "jax")


# ==========================================================================
# scheduler: the registry behind stats() (the repair)
# ==========================================================================
def test_scheduler_stats_keys_and_empty_view_match_the_reference():
    ours = Scheduler(None, max_lanes=2, blocks_per_lane=4).stats()
    ref = JScheduler(None, max_lanes=2, blocks_per_lane=4).stats()
    assert ours == ref
    for k in ("ttft_ticks_p50", "ttft_ticks_p90", "ttft_ticks_p99", "latency_ticks_p50",
              "latency_ticks_p90", "latency_ticks_p99", "ttft_s_p50", "itl_s_p99"):
        assert ours[k] is None, k
    alloc = Scheduler(paged.BlockAllocator(9, 8), 2, 4).stats()
    assert set(alloc) == set(JScheduler(jpaged.BlockAllocator(9, 8), 2, 4).stats())


@pytest.mark.parametrize("side", ["port", "jax"])
def test_scheduler_percentiles_p90_p99(side):
    """``tests/test_telemetry.py:test_scheduler_percentiles_p90_p99`` on
    both schedulers: ten requests with TTFTs of 1..10 ticks; the tick
    percentiles are bucket bounds, exact in unit buckets."""
    sched_cls, req_cls = (Scheduler, Request) if side == "port" else (JScheduler, JRequest)
    s = sched_cls(None, max_lanes=1, blocks_per_lane=4)
    s.requeue_cb = lambda lane: None
    for uid in range(10):
        s.tick_now = uid * 100
        s.submit(req_cls(uid, [5, 6, 7], max_new_tokens=4))
        [(lane, _)] = s.admit()
        s.tick_now = uid * 100 + uid + 1
        s.note_token(uid)
        s.note_token(uid)
        s.release(lane)
    st = s.stats()
    assert (st["ttft_ticks_p50"], st["ttft_ticks_p90"], st["ttft_ticks_p99"]) == (5.0, 9.0, 10.0)
    assert st["latency_ticks_p50"] == 5.0 and st["finished"] == 10
    assert st["itl_s_p50"] is not None
    assert s.registry.get("serve_itl_seconds").count == 10
    assert s.registry.get("serve_tokens_total").value == 20


def test_scheduler_flight_events_match_the_reference():
    """Submit, reject, admit, preempt, requeue, cow, park_drop, finish,
    cancel and deadline through the same calls on both schedulers: the
    same lifelines and the same snapshot."""
    def run(side):
        if side == "port":
            sched_cls, req_cls, alloc, reg, fl = (Scheduler, Request, paged.BlockAllocator(9, 4),
                                                  tel.MetricsRegistry(), tel.FlightRecorder())
        else:
            sched_cls, req_cls, alloc, reg, fl = (JScheduler, JRequest,
                                                  jpaged.BlockAllocator(9, 4),
                                                  JMetricsRegistry(), JFlightRecorder())
        s = sched_cls(alloc, max_lanes=2, blocks_per_lane=4, registry=reg, flight=fl,
                      chunk_tokens=4, max_queue=3)
        reqs = {u: req_cls(u, list(range(3, 3 + n)), max_new_tokens=4)
                for u, n in enumerate((6, 9, 5, 7))}
        seated = {}
        s.requeue_cb = lambda lane: seated.pop(lane)
        s.park_cb = lambda lane: s.lane_uid[lane] == 1
        for u in range(4):
            s.submit(reqs[u])            # uid 3 is past max_queue: rejected
        s.tick_now = 1
        for lane, req in s.admit():      # uids 0 and 1, one chunk's block each
            seated[lane] = req
            s.note_token(req.uid)
        s.tick_now = 2
        s.ensure_block(0, 6)             # uid 0 grows to two blocks
        s.preempt(1)                     # uid 1: parked, requeued
        s.reclaim_parked()               # its blocks reclaimed: park_drop
        s.tick_now = 3
        alloc.take_ref(alloc.tables[0][0])
        s.ensure_block(0, 2)             # a shared block: copy-on-write
        s.note_token(0)
        s.release(0)                     # finish
        s.remove_waiting(2)
        s.mark_terminal(2, "cancelled")
        s.remove_waiting(1)
        s.mark_terminal(1, "deadline_expired")
        return (_lifelines(fl), reg.snapshot().get("serve_tokens_total"),
                {k: v for k, v in reg.snapshot().items()
                 if k in DETERMINISTIC}, s.stats()["cow_copies"])

    ours, ref = run("port"), run("jax")
    assert ours == ref
    kinds = {uid: [e["kind"] for e in evs] for uid, (evs, _) in ours[0].items()}
    assert kinds == {0: ["submit", "admit", "cow", "finish"],
                     1: ["submit", "admit", "preempt", "requeue", "park_drop", "deadline"],
                     2: ["submit", "cancel"], 3: ["reject"]}
    assert ours[3] == 1


def test_prefix_cache_registry_matches_the_reference():
    """Hits (with their block counts), misses and evictions in the
    registry, ``stats()`` keys and values unchanged."""
    def run(m, reg):
        alloc = m.BlockAllocator(17, 4)
        pc = m.PrefixCache(alloc, max_blocks=3, registry=reg)
        alloc.alloc(0, 2)
        entry = pc.insert(list(range(8)), alloc.tables[0])
        pc.note_hit(entry, 2)
        pc.note_miss()
        alloc.alloc(1, 2)
        pc.insert(list(range(20, 28)), alloc.tables[1])  # past max_blocks: evicts
        alloc.free(0)
        alloc.free(1)
        pc.evict_one()
        return pc.stats(), pc.registry.snapshot()

    ours = run(paged, tel.MetricsRegistry())
    assert ours == run(jpaged, JMetricsRegistry())
    assert (ours[0]["hits"], ours[0]["misses"], ours[0]["evictions"]) == (1, 1, 2)
    assert ours[1]["prefix_hit_blocks"]["count"] == 1
    assert run(paged, None) == ours  # a private registry by default


def test_chaos_injector_records_like_the_reference():
    def run(m, fl, reg):
        plan = m.FaultPlan(seed=0, rules=(m.FaultRule("drop_sample", rate=0.5),
                                          m.FaultRule("admission_stall", start_tick=2)))
        inj = m.ChaosInjector(plan, flight=fl, registry=reg)
        for tick in range(1, 5):
            inj.begin_tick(tick)
            for lane in range(3):
                inj.fire("drop_sample", lane=lane)
            inj.fire("admission_stall")
        return inj.injections, _lifelines(fl), reg.snapshot()

    ours = run(chaos, tel.FlightRecorder(), tel.MetricsRegistry())
    assert ours == run(jchaos, JFlightRecorder(), JMetricsRegistry())
    assert ours[0] > 0 and sum(v["value"] for v in
                               ours[2]["chaos_injections_total"].values()) == ours[0]


# ==========================================================================
# the engine on four routes, against the JAX engine
# ==========================================================================
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tokens_and_lifelines_equal_jax(weights, route):
    port, ref = _both(weights, route)
    assert port["outputs"] == ref["outputs"] and port["outcomes"] == ref["outcomes"]
    assert port["lifelines"] == ref["lifelines"]
    kinds = {e["kind"] for evs, _ in port["lifelines"].values() for e in evs}
    want = {"two_phase_exact": {"prefill_start", "prefill_end", "decode", "preempt",
                                "requeue", "finish"},
            "frozen_gather": {"prefill_start", "decode", "rebase", "finish"},
            "chunked_prefix": {"prefill_chunk", "prefix_attach", "cow", "decode", "finish"},
            "chaos_seed0": {"chaos", "prefill_chunk", "preempt", "finish"}}[route]
    assert want <= kinds, want - kinds


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_counters_and_tick_histograms_equal_jax(weights, route):
    port, ref = _both(weights, route)
    ours = {k: v for k, v in port["snap"].items() if k in DETERMINISTIC}
    assert ours == {k: v for k, v in ref["snap"].items() if k in DETERMINISTIC}
    for name in ("serve_ticks_total", "serve_admitted_total", "serve_tokens_total",
                 "serve_ttft_ticks", "serve_latency_ticks"):
        assert name in ours, name
    snap = port["snap"]
    if route == "chunked_prefix":
        assert min(snap[n]["value"] for n in ("prefix_cache_hits_total",
                                              "prefix_cache_misses_total",
                                              "prefix_cache_evictions_total",
                                              "prefix_cow_copies_total")) >= 1
    if route == "chaos_seed0":
        assert (sum(v["value"] for v in snap["chaos_injections_total"].values())
                == port["stats"]["chaos_injections"] > 0)
    if route == "two_phase_exact":
        assert snap["numerics_checks_total"]["value"] > 0
        assert "numerics_nonfinite_total" not in snap
    for name in MONITORS:
        if name in ref["snap"]:
            assert snap[name]["value"] == pytest.approx(ref["snap"][name]["value"], rel=1e-3)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_span_names_per_tick_equal_jax(weights, route):
    port, ref = _both(weights, route)
    assert port["ticks"] == ref["ticks"]
    assert len(port["ticks"]) == port["stats"]["ticks"]
    names = {name for tick in port["ticks"] for name, _, _ in tick}
    assert {"serve_tick", "admit", "decode_dispatch", "device_sync", "sample_emit"} <= names
    assert ("rebase" in names) == (route == "frozen_gather")
    assert ("prefill_chunk" in names) == ROUTES[route][0].get("chunked_prefill", False)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_scheduler_stats_equal_jax(weights, route):
    """The repair: the reference's keys, and its tick percentiles on the
    same run."""
    port, ref = _both(weights, route)
    assert set(port["sched"]) == set(ref["sched"])
    ticks = [k for k in ref["sched"] if k.startswith(("ttft_ticks", "latency_ticks"))]
    assert len(ticks) == 6
    assert {k: port["sched"][k] for k in ticks} == {k: ref["sched"][k] for k in ticks}
    assert port["sched"]["ttft_ticks_p99"] is not None
    for k, v in ref["sched"].items():
        if not k.endswith(("_s_p50", "_s_p99")):
            assert port["sched"][k] == v, k


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_program_shapes_equal_xla_compiles_and_stay_flat(weights, route):
    """Program by program, the port's first-seen argument signatures equal
    the JAX engine's jit cache misses, with one named difference: on the
    paged route the reference slices the block tables to a bucketed view
    length (``n_view_blocks``) before its jitted decode tick, one compile
    per bucket, where the port's paged tick takes the whole table (K5
    reads each lane up to its ``kv_valid``), one signature. A second pass
    of the same requests adds no signature."""
    port, ref = _both(weights, route)
    assert set(port["shapes"]) == set(ref["shapes"]) == set(PROGRAMS)
    for program, compiles in ref["shapes"].items():
        if program in ("decode_tick", "decode_exact") and port["engine"].decode_impl == "paged":
            assert port["shapes"][program] == min(compiles, 1), program
        else:
            assert port["shapes"][program] == compiles, program
    assert port["shapes"]["decode_tick"] >= 1
    assert port["shapes_again"] == port["shapes"]


def test_drift_residuals_equal_jax(weights):
    """Frozen boundary rebases: one residual per lane rebase on each side,
    value by value within rel 1e-3. The spread measured on this run is
    6.5e-6 at most (5 rebases, residuals 1.54-1.77): the random-weight
    core amplifies fp32 rounding (ROADMAP P1), so the streamed rows sit
    O(1) off the exact ones in both engines, and the two engines' rows
    differ at rounding level."""
    port, ref = _both(weights, "frozen_gather")
    assert len(port["drift"]) == len(ref["drift"]) == port["stats"]["rebases"] > 0
    assert port["snap"]["drift_rebase_residual"]["count"] == port["stats"]["rebases"]
    np.testing.assert_allclose(port["drift"], ref["drift"], rtol=1e-3)


def test_jsonl_and_trace_of_an_engine_run(weights, tmp_path):
    """The JSONL contract (``tests/test_telemetry.py:318``, the port's
    core families) and a valid Perfetto trace, on the frozen and the
    chunked routes."""
    frozen = _route(weights, "frozen_gather", "port")["engine"]
    path = tmp_path / "telemetry.jsonl"
    n = frozen.telemetry.dump_jsonl(path, meta={"bench": "test"})
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == n and lines[0]["kind"] == "meta"
    head = lines[0]
    assert head["schema"] == "repro-telemetry-v1" and head["torch"] == torch.__version__
    assert head["config_hash"] == tel.config_hash(frozen.cfg, frozen.serve)
    names = {line["name"] for line in lines if line["kind"] == "metric"}
    assert set(CORE_FAMILIES) <= names, set(CORE_FAMILIES) - names
    assert {"serve_tick", "decode_dispatch", "device_sync", "rebase"} <= {
        line["name"] for line in lines if line["kind"] == "span"}
    drift = next(line for line in lines if line.get("name") == "drift_rebase_residual")
    assert drift["count"] == frozen.stats()["rebases"]
    assert sum(line["kind"] == "flight" for line in lines) == 8
    for route in ("frozen_gather", "chunked_prefix"):
        eng = _route(weights, route, "port")["engine"]
        trace = tel.chrome_trace(eng.telemetry)
        assert tel.validate_trace(trace) == []
        evs = trace["traceEvents"]
        assert {"queue_depth", "pool_blocks_used", "pool_fragmentation"} <= {
            e["name"] for e in evs if e["ph"] == "C"}
        if route == "chunked_prefix":
            assert {"prefill_chunk", "prefix_attach", "cow"} <= {e["name"] for e in evs}


def test_telemetry_off_is_identical_and_clean(weights):
    """``telemetry=False``: the tokens of the telemetry-on run (and the JAX
    engine's), the null registry, no telemetry key in ``stats()``, the
    scheduler's percentiles still populated."""
    on = _route(weights, "two_phase_exact", "port")
    eng = ServeEngine(dataclasses.replace(weights["port"][0], decode_streaming="exact"),
                      weights["port"][1],
                      serve=base.ServeConfig(**dict(ROUTES["two_phase_exact"][0])),
                      device="cpu")
    _drive(eng, "port", "two_phase_exact")
    assert dict(eng.finished) == on["outputs"]
    st = eng.stats()
    assert set(on["stats"]) - set(st) == {"telemetry", "flight", "program_shapes"}
    assert set(st) <= set(on["stats"])
    assert isinstance(eng.telemetry.metrics, tel.NullRegistry)
    assert eng.telemetry.metrics.snapshot() == {} and eng.telemetry.flight.lifelines() == []
    assert eng.telemetry.tracer.events == [] and eng._acct is None
    assert st["ttft_ticks_p99"] is not None and st["latency_ticks_p90"] is not None
    assert eng.sched.registry is not None and eng.sched.registry.snapshot()


def test_a_dropped_telemetry_engine_is_freed(weights):
    """Nothing process-wide keeps a telemetry-on engine (and its weights)
    alive once its owner drops it: the kernel-build hook holds the
    engine's registry weakly."""
    import gc
    import weakref

    from repro_torch.telemetry import accounting

    eng = _engine(weights, "port", "chunked_prefix")
    assert accounting._metrics() is eng.telemetry.metrics
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None and isinstance(accounting._metrics(), tel.NullRegistry)


def test_annotated_engine_run_reaches_the_profiler(weights, tmp_path):
    """An engine with ``Telemetry(annotate=True)`` under ``profile_session``:
    every span name of the run appears among the profiler's events."""
    t = tel.Telemetry(annotate=True)
    eng = ServeEngine(weights["port"][0], weights["port"][1],
                      serve=base.ServeConfig(**PAGED), device="cpu", telemetry=t)
    with tel.profile_session(str(tmp_path)) as prof:
        eng.submit(Request(0, list(range(3, 23)), max_new_tokens=3))
        eng.run()
    spans = {e["name"] for e in t.tracer.events}
    assert {"serve_tick", "admit", "prefill", "decode_dispatch", "device_sync",
            "sample_emit"} <= spans
    assert spans <= {e.name for e in prof.events()}
    assert (tmp_path / "torch_trace.json").exists()


def test_deepseek_serves_with_telemetry(weights):
    """Reduced DeepSeek-V2-Lite (family ``moe``: absorbed MLA + MoE) on the
    main route with telemetry on: the tokens of telemetry off, and the
    engine's counters and spans."""
    cfg = dataclasses.replace(base.reduced(get_config("deepseek-v2-lite-16b")),
                              capacity_factor=100.0)
    params = random_params(cfg, seed=0, device="cpu")
    outs = {}
    for on in (True, False):
        eng = ServeEngine(cfg, params, serve=base.ServeConfig(**dict(PAGED, telemetry=on)),
                          device="cpu")
        rng = np.random.default_rng(0)
        for u, n in enumerate((10, 29, 20)):
            eng.submit(Request(u, rng.integers(3, cfg.vocab_size, n).tolist(),
                               max_new_tokens=5))
        outs[on] = eng.run()
        if on:
            snap = eng.telemetry.metrics.snapshot()
            assert snap["serve_tokens_total"]["value"] == 15
            assert snap["spectrum_observations_total"]["value"] == 3
            assert eng.stats()["program_shapes"]["decode_tick"] == 1
            assert {e["name"] for e in eng.telemetry.tracer.events} >= {"prefill", "device_sync"}
    assert outs[True] == outs[False]


# ==========================================================================
# trainer and launcher
# ==========================================================================
def test_trainer_telemetry(tmp_path):
    """Three CPU steps with a ``Telemetry``: one ``train_step`` span per step
    (labelled with it), ``train_step_seconds`` counts them, the gauges hold
    the last step's ``metrics_history`` values, the step program has one
    signature, provenance names the configs; the losses equal a run without
    telemetry."""
    cfg = dataclasses.replace(base.reduced(get_config("qwen2-7b")), num_layers=1,
                              attention_impl="spectral_shift_fused")
    shape = base.ShapeConfig("t", 40, 2, "train")
    t = tel.Telemetry()
    runs, tcfgs = {}, {}
    for name, telemetry in (("on", t), ("off", None)):
        tcfgs[name] = base.TrainConfig(checkpoint_dir=str(tmp_path / name), total_steps=10,
                                       warmup_steps=1, checkpoint_every=0)
        runs[name] = Trainer(cfg, tcfgs[name], shape, device="cpu",
                             telemetry=telemetry).run(3)
    hist = runs["on"]
    assert [h["loss"] for h in hist] == [h["loss"] for h in runs["off"]]
    spans = [e for e in t.tracer.events if e["name"] == "train_step"]
    assert [e["labels"] for e in spans] == [{"step": i} for i in range(3)]
    snap = t.metrics.snapshot()
    assert snap["train_step_seconds"]["count"] == 3
    assert snap["span_seconds"]["span=train_step"]["count"] == 3
    for name in ("loss", "ce", "grad_norm", "lr"):
        assert snap[f"train_{name}"]["value"] == hist[-1][name]
    assert snap["program_shapes_total"]["program=train_step"]["value"] == 1
    assert snap["program_calls_total"]["program=train_step"]["value"] == 3
    assert t.meta_defaults["config_hash"] == tel.config_hash(cfg, tcfgs["on"])


def test_launcher_writes_metrics_out(tmp_path):
    out = tmp_path / "metrics.json"
    hist = launch_train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                              "--seq", "40", "--layers", "1", "--metrics-out", str(out)])
    written = json.loads(out.read_text())
    assert len(written) == 2 and written == json.loads(json.dumps(hist))
    assert {"loss", "ce", "grad_norm", "lr", "step", "step_time_s"} <= set(written[0])
