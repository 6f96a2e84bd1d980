"""The port's chaos harness and recovery ladder against the JAX reference,
on the CPU.

The oracles of ``tests/test_chaos.py`` replayed on the port's
``ServeEngine(device="cpu")`` with reduced Qwen2-7B and the reference's
own weights (through ``params_from_numpy``):

* the injector: rule validation, and the firing schedule (which call
  fires, with which rule) and ``injections`` of ``repro_torch``'s
  ``ChaosInjector`` identical to ``repro.serve.chaos.ChaosInjector``'s
  (a module without JAX) on the same calls;
* ``max_queue`` rejection and recovery, cancellation (queued, seated,
  from ``on_token``), deadlines (queued, seated, mid-decode), the
  watchdog's ``EngineStalled`` (its fields) and the watchdog off by
  default: each run on both engines, the same outcomes, tokens and
  counters;
* the numerics guard's ladder: quarantine + reseed (exact streaming:
  tokens of the fault-free run), non-finite logits replay-preempt, a
  frozen lane demoted after two trips, and the guard off as silent
  corruption; ``quarantines``, ``demotions`` and preemptions equal the
  JAX engine's;
* a chaos run replays bit-identically;
* the soak: the reference's four plans x seeds 0-2 on its Poisson trace
  (``telemetry=False``; the chaos flight events and
  ``chaos_injections_total`` with telemetry on are held to the JAX engine
  in ``tests/test_torch_telemetry_engine.py``). Every run drains, every
  uid ends ``finished``, no block leaks, and the tokens equal the JAX
  engine's fault-free run on that seed's trace. At seed 0 the JAX chaos
  engine runs too, and the port's ``injections``, outcomes and
  preemptions equal its own. Each JAX run is made once per module.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models.model import model_specs as jmodel_specs  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.serve import chaos as jchaos  # noqa: E402
from repro.serve import workload as jworkload  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serve import chaos  # noqa: E402
from repro_torch.serve import workload  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

BASE = dict(max_lanes=2, max_seq=64, block_size=8)
GUARD = dict(BASE, numerics_guard=True, numerics_demote_after=2)
SOAK = dict(BASE, prefix_cache=True, chunked_prefill=True, watchdog_ticks=16)
PROMPT = list(range(7, 7 + 11))  # the guard-ladder tests' prompt
PLANS = {
    "alloc": (("alloc_fail", dict(rate=0.15)), ("fragment", dict(rate=0.5))),
    "stall": (("admission_stall", dict(start_tick=3, end_tick=10)),
              ("tick_delay", dict(rate=0.2, param=1e-4))),
    "drop": (("drop_sample", dict(rate=0.1)),),
    "cache": (("hash_collision", dict(rate=0.5)),
              ("evict_storm", dict(rate=0.25, param=2))),
}
SEEDS = (0, 1, 2)
# side -> (engine, request, chaos module, workload module)
SIDES = {"port": (ServeEngine, Request, chaos, workload),
         "jax": (JServeEngine, JRequest, jchaos, jworkload)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines run many small ops: one intra-op thread per test worker
    keeps parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jbase.reduced(jget_config("qwen2-7b")),
                               capacity_factor=100.0)
    cfg = dataclasses.replace(base.reduced(get_config("qwen2-7b")),
                              capacity_factor=100.0)
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(0))
    return {"jax": (jcfg, jparams),
            "port": (cfg, params_from_numpy(jax.tree.map(np.asarray, jparams)))}


def _plan(side, seed, rules):
    m = SIDES[side][2]
    return m.FaultPlan(seed=seed, rules=tuple(m.FaultRule(s, **kw) for s, kw in rules))


def _engine(weights, side, serve_kw, plan=None, **model_kw):
    eng_cls, _, _, _ = SIDES[side]
    cfg, params = weights[side]
    cfg = dataclasses.replace(cfg, **model_kw)
    serve = (base if side == "port" else jbase).ServeConfig(**serve_kw)
    kw = dict(device="cpu") if side == "port" else {}
    return eng_cls(cfg, params, serve=serve, chaos=plan, **kw)


def _requests(side, vocab, n, max_new=6, seed=0):
    """``tests/test_chaos.py:_mk_reqs``."""
    rng = np.random.default_rng(seed)
    req = SIDES[side][1]
    return [req(u, rng.integers(3, vocab, int(rng.integers(5, 20))).tolist(),
                max_new_tokens=max_new) for u in range(n)]


def _assert_no_leaks(eng):
    """``tests/test_chaos.py:_assert_no_leaks``: after drain the free list
    and the referenced set partition the pool, and every surviving
    reference is a prefix-cache retention."""
    alloc = eng.sched.allocator
    if alloc is None:
        return
    assert alloc.tables == {}, f"leaked tables: {alloc.tables}"
    free = alloc._free
    assert len(free) == len(set(free)), "free-list duplicates"
    refed = set(alloc.refcounts)
    assert refed.isdisjoint(free), "block both free and referenced"
    assert refed | set(free) == set(range(1, alloc.num_blocks))
    if eng.prefix is not None:
        for b in refed:
            assert alloc.refcounts[b] == eng.prefix._cache_refs.get(b, 0)
    else:
        assert alloc.num_used == 0


def _on_both(fn):
    """Run ``fn(side)`` for the port and the reference; both must pass
    their asserts and return the same value."""
    ours, ref = fn("port"), fn("jax")
    assert ours == ref
    return ours


# ==========================================================================
# The injector
# ==========================================================================
class TestInjector:
    @pytest.mark.parametrize("side", sorted(SIDES))
    def test_rule_validation(self, side):
        m = SIDES[side][2]
        with pytest.raises(ValueError, match="unknown chaos site"):
            m.FaultRule("explode")
        with pytest.raises(ValueError, match="rate"):
            m.FaultRule("alloc_fail", rate=1.5)

    @pytest.mark.parametrize("rules", [
        (("drop_sample", dict(start_tick=5, end_tick=7, lane=1)),),
        (("alloc_fail", dict(rate=0.4)),),
        (("alloc_fail", dict(rate=0.15)), ("fragment", dict(rate=0.5)),
         ("nan_stats", dict(rate=0.3, lane=0)), ("drop_sample", dict(rate=0.1))),
        (("tick_delay", dict(rate=0.2, param=1e-4)),
         ("admission_stall", dict(start_tick=3, end_tick=10)),
         ("drop_sample", dict(rate=0.5, start_tick=2)),
         ("drop_sample", dict(rate=0.5, lane=1))),
    ], ids=["window_lane", "rate", "mixed", "two_rules_one_site"])
    @pytest.mark.parametrize("seed", [0, 11])
    def test_schedule_identical_to_reference(self, rules, seed):
        """Every opportunity (several per tick and site, lane-scoped and
        not) fires the same rule, or none, in both injectors."""
        def schedule(side):
            inj = SIDES[side][2].ChaosInjector(_plan(side, seed, rules))
            fired = []
            for tick in range(1, 40):
                inj.begin_tick(tick)
                for site in chaos.SITES:
                    for lane in (None, 0, 1, None):
                        rule = inj.fire(site, lane=lane)
                        fired.append(None if rule is None else dataclasses.astuple(rule))
            return fired, inj.injections
        fired, injections = _on_both(schedule)
        assert injections == sum(r is not None for r in fired) > 0

    def test_per_site_counts(self):
        inj = chaos.ChaosInjector(_plan("port", 0, (("tick_delay", {}),
                                                    ("fragment", dict(rate=0.5)))))
        for tick in range(1, 21):
            inj.begin_tick(tick)
            inj.fire("tick_delay")
            inj.fire("fragment")
            assert inj.fire("alloc_fail") is None  # no rule for the site
        assert inj.by_site["tick_delay"] == 20
        assert sum(inj.by_site.values()) == inj.injections

    @pytest.mark.parametrize("side", sorted(SIDES))
    def test_engine_stalled_structure(self, side):
        err = SIDES[side][2].EngineStalled(tick=9, stall_ticks=4, waiting=2,
                                           active_lanes=0, parked=1,
                                           pool={"blocks_free": 0})
        assert err.tick == 9 and err.waiting == 2
        assert "no progress for 4 ticks" in str(err)


# ==========================================================================
# Rejection, cancellation, deadlines, the watchdog
# ==========================================================================
def test_bounded_queue_rejects_and_recovers(weights):
    vocab = weights["port"][0].vocab_size

    def case(side):
        eng = _engine(weights, side, dict(BASE, max_queue=2))
        reqs = _requests(side, vocab, 4)
        accepted = [eng.submit(r) for r in reqs]
        assert accepted == [True, True, False, False]
        eng.run()
        assert eng.stats()["rejected"] == 2
        # backpressure is advisory: a resubmit once the queue drained is
        # accepted and sheds the stale "rejected"
        assert eng.submit(SIDES[side][1](2, list(reqs[2].prompt), max_new_tokens=4))
        out = eng.run()
        _assert_no_leaks(eng)
        return out, eng.outcomes
    out, outcomes = _on_both(case)
    assert outcomes == {0: "finished", 1: "finished", 2: "finished", 3: "rejected"}


def test_cancel_queued_and_active(weights):
    vocab = weights["port"][0].vocab_size

    def case(side):
        eng = _engine(weights, side, BASE)
        for r in _requests(side, vocab, 3, max_new=8):
            eng.submit(r)
        assert eng.cancel(2)          # queued: never reaches a lane
        eng.tick()
        eng.tick()
        assert any(l.req is not None and l.req.uid == 0 for l in eng.lanes)
        assert eng.cancel(0)          # seated, mid-decode
        assert all(l.req is None or l.req.uid != 0 for l in eng.lanes)
        assert not eng.cancel(99) and not eng.cancel(0)
        out = eng.run()
        st = eng.stats()
        assert st["cancelled"] == 2 and st["finished"] == 1
        _assert_no_leaks(eng)
        return out, eng.outcomes
    out, outcomes = _on_both(case)
    assert outcomes == {0: "cancelled", 2: "cancelled", 1: "finished"}


def test_cancel_from_on_token_callback(weights):
    """Cancelling its own request from the token callback leaves the emit
    path intact (the lane is gone when the callback returns)."""
    def case(side):
        eng = _engine(weights, side, BASE)
        seen = []

        def bail(uid, tok):
            seen.append(tok)
            eng.cancel(uid)

        eng.submit(SIDES[side][1](0, PROMPT, max_new_tokens=16, on_token=bail))
        out = eng.run()
        assert len(seen) == 1 and eng.outcomes == {0: "cancelled"} and 0 not in out
        _assert_no_leaks(eng)
        return seen
    _on_both(case)


def test_deadlines_expire_queued_and_seated(weights):
    """One lane: uid 0 holds it, uid 1's deadline expires in the queue,
    uid 2's budget outlasts the backlog."""
    def case(side):
        req = SIDES[side][1]
        eng = _engine(weights, side, dict(BASE, max_lanes=1))
        eng.submit(req(0, PROMPT, max_new_tokens=16))
        eng.submit(req(1, list(PROMPT), max_new_tokens=4, deadline_ticks=2))
        eng.submit(req(2, list(PROMPT), max_new_tokens=4, deadline_ticks=60))
        out = eng.run()
        st = eng.stats()
        assert st["deadline_expired"] == 1 and st["finished"] == 2
        _assert_no_leaks(eng)
        return out, eng.outcomes
    _, outcomes = _on_both(case)
    assert outcomes == {0: "finished", 1: "deadline_expired", 2: "finished"}


def test_deadline_expires_mid_decode(weights):
    def case(side):
        req = SIDES[side][1]
        eng = _engine(weights, side, BASE)
        eng.submit(req(0, PROMPT, max_new_tokens=32, deadline_ticks=4))
        eng.submit(req(1, list(PROMPT), max_new_tokens=4))
        out = eng.run()
        assert 0 not in out and out[1]
        _assert_no_leaks(eng)
        return out, eng.outcomes
    _, outcomes = _on_both(case)
    assert outcomes == {0: "deadline_expired", 1: "finished"}


def test_watchdog_raises_engine_stalled(weights):
    """An open-ended admission stall with no lane seated: nothing to
    reclaim or preempt, so the watchdog reports the wedge."""
    vocab = weights["port"][0].vocab_size

    def case(side):
        eng = _engine(weights, side, dict(BASE, watchdog_ticks=3),
                      plan=_plan(side, 0, (("admission_stall", {}),)))
        for r in _requests(side, vocab, 2):
            eng.submit(r)
        with pytest.raises(SIDES[side][2].EngineStalled) as ei:
            eng.run(max_ticks=50)
        err = ei.value
        assert err.waiting == 2 and err.active_lanes == 0
        assert eng.stats()["watchdog_fires"] == 1
        return (err.tick, err.stall_ticks, err.waiting, err.active_lanes, err.parked,
                err.pool, str(err), eng.stats()["chaos_injections"])
    _on_both(case)


def test_watchdog_off_by_default(weights):
    """watchdog_ticks=0 never raises: the same wedge burns the budget."""
    vocab = weights["port"][0].vocab_size

    def case(side):
        eng = _engine(weights, side, BASE, plan=_plan(side, 0, (("admission_stall", {}),)))
        for r in _requests(side, vocab, 2):
            eng.submit(r)
        eng.run(max_ticks=20)
        assert not eng.finished and eng.stats()["watchdog_fires"] == 0
        return eng._tick, eng.stats()["chaos_injections"]
    _on_both(case)


# ==========================================================================
# The numerics guard's ladder
# ==========================================================================
def _guard_run(weights, side, serve_kw, rules, seed, **model_kw):
    plan = _plan(side, seed, rules) if rules else None
    eng = _engine(weights, side, serve_kw, plan=plan, **model_kw)
    eng.submit(SIDES[side][1](0, PROMPT, max_new_tokens=12))
    out = eng.run()
    _assert_no_leaks(eng)
    st = eng.stats()
    return out, {k: st.get(k) for k in ("quarantines", "demotions", "preemptions",
                                        "chaos_injections", "finished")}


@pytest.fixture(scope="module")
def exact_clean(weights):
    """The fault-free exact-streaming run, from the JAX engine."""
    return _guard_run(weights, "jax", BASE, (), 0)[0]


def test_guard_quarantine_reseed_is_exact(weights, exact_clean):
    """NaN stats with K/V intact: the lane is quarantined and every stats
    row rebuilt from K/V, which in exact mode IS the clean state: the
    fault-free tokens."""
    rules = (("nan_stats", dict(lane=0, start_tick=3, end_tick=3)),)
    out, st = _on_both(lambda side: _guard_run(weights, side, GUARD, rules, 1))
    assert out == exact_clean
    assert st["quarantines"] == 1 and st["demotions"] == 0
    assert st["chaos_injections"] == 1


def test_guard_nan_logits_replay_preempts(weights, exact_clean):
    rules = (("nan_logits", dict(lane=0, start_tick=3, end_tick=3)),)
    out, st = _on_both(lambda side: _guard_run(weights, side, GUARD, rules, 2))
    assert out == exact_clean
    assert st["quarantines"] == 0 and st["preemptions"] >= 1


def test_guard_escalates_frozen_lane_to_exact(weights):
    """A frozen lane tripping twice: quarantine + reseed each time, then
    demotion to the exact program; the request still completes."""
    rules = (("nan_stats", dict(lane=0, start_tick=3, end_tick=4)),)
    out, st = _on_both(lambda side: _guard_run(weights, side, GUARD, rules, 3,
                                               decode_streaming="frozen"))
    assert st["quarantines"] == 2 and st["demotions"] == 1
    assert st["finished"] == 1 and out[0]


def test_guard_off_is_silent_corruption(weights):
    """Without the guard the same NaN stats poison every later step: the
    request "finishes" with garbage tokens."""
    rules = (("nan_stats", dict(lane=0, start_tick=3, end_tick=4)),)
    poisoned, _ = _on_both(lambda side: _guard_run(weights, side, BASE, rules, 3,
                                                   decode_streaming="frozen"))
    clean, _ = _guard_run(weights, "port", dict(BASE, numerics_guard=True), rules, 3,
                          decode_streaming="frozen")
    assert poisoned[0][:2] == clean[0][:2]
    assert poisoned[0] != clean[0]


# ==========================================================================
# Replay, and the soak
# ==========================================================================
def test_chaos_run_replays_bit_identical(weights):
    cfg = weights["port"][0]
    trace = workload.poisson_trace(seed=7, n_requests=3, mean_interarrival_ticks=2,
                                   prompt_lens=(5, 12), vocab_size=cfg.vocab_size,
                                   max_new_tokens=4)

    def run():
        eng = _engine(weights, "port", BASE,
                      plan=_plan("port", 7, (("drop_sample", dict(rate=0.3)),)))
        workload.replay_trace(eng, trace, max_ticks=500)
        return eng.finished, eng.chaos.injections

    (out_a, inj_a), (out_b, inj_b) = run(), run()
    assert out_a == out_b
    assert inj_a == inj_b and inj_a > 0


_JAX_RUNS: dict = {}  # (plan or None, seed) -> the JAX soak run's results


def _soak(weights, side, plan_name, seed):
    trace = SIDES[side][3].poisson_trace(
        seed=seed, n_requests=6, mean_interarrival_ticks=2, prompt_lens=(5, 12, 21),
        vocab_size=weights[side][0].vocab_size, max_new_tokens=6)
    plan = None if plan_name is None else _plan(side, seed, PLANS[plan_name])
    eng = _engine(weights, side, SOAK, plan=plan)
    SIDES[side][3].replay_trace(eng, trace, max_ticks=1500)
    assert eng.sched.idle, "engine failed to drain within the budget"
    for it in trace:
        assert eng.outcomes.get(it.uid) == "finished" and it.uid in eng.finished
    _assert_no_leaks(eng)
    st = eng.stats()
    return dict(eng.finished), dict(eng.outcomes), st.get("chaos_injections"), \
        st["preemptions"]


def _jax_soak(weights, plan_name, seed):
    key = (plan_name, seed)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _soak(weights, "jax", plan_name, seed)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_chaos_soak(weights, plan_name, seed):
    out, outcomes, injections, preemptions = _soak(weights, "port", plan_name, seed)
    assert injections > 0
    # performance faults never change greedy tokens
    assert out == _jax_soak(weights, None, seed)[0]
    if seed == 0:
        assert (out, outcomes, injections, preemptions) == _jax_soak(weights, plan_name,
                                                                     seed)
