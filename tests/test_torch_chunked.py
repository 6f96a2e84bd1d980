"""The port's continuous-batching tick (chunked prefill inside the decode
tick, with parking) against the JAX reference, on the CPU.

The oracles of ``tests/test_chunked_prefill.py`` replayed on the port's
``ServeEngine(device="cpu")``, with reduced Qwen2-7B and the reference's
own weights (through ``params_from_numpy``): chunked prefill is greedy
token-identical to the whole-prompt two-phase engine (paged and
lane-dense, chunks 8 / 16 / 24 / 32) and to token replay, with the
``ss_fused`` stats handoff too (chunk 32 > c = 16 runs the K1 site, whose
plain version runs here); a tight pool preempts and parks mid-prefill
without changing a token; a lane preempted while the pool has room parks
and resumes at its chunk boundary; the all-prefill deadlock breaker
drains; decode never waits a tick under a long-prompt flood; a Poisson
trace replays
deterministically. Where the oracle records them, the port's ``on_token``
calls and ``stats()`` (mode, preemptions) are the JAX engine's. Each JAX
engine run is made once per module.

At layer level: ``_merge_chunk_stats`` (the K1 site under ``ss_fused``,
the Pallas kernel interpreted on the JAX side) and two consecutive chunks
of ``chunk_prefill``, against the reference's functions: at 1 layer the
stats (m, l, acc) within 1e-5 and the logits within 5e-5 of max-abs, at
2 layers 5e-4 (random weights amplify rounding with depth, ROADMAP P1).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models.model import model_specs as jmodel_specs  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.serve import prefill as jprefill  # noqa: E402
from repro.serve import workload as jworkload  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.paged import BlockAllocator as JBlockAllocator  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serve import prefill  # noqa: E402
from repro_torch.serve import workload  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.paged import BlockAllocator  # noqa: E402
from repro_torch.serve.scheduler import Scheduler  # noqa: E402

PROMPT_LENS = (37, 9, 24, 50)
MAX_NEW = 6
BASE = dict(max_lanes=2, max_seq=64, block_size=8)
TIGHT = dict(BASE, chunked_prefill=True, prefill_chunk_tokens=8, num_blocks=12)
DEADLOCK = dict(max_lanes=4, max_seq=64, block_size=8, chunked_prefill=True,
                prefill_chunk_tokens=16, num_blocks=10)
FLOOD = dict(max_lanes=2, max_seq=96, block_size=8, chunked_prefill=True,
             prefill_chunk_tokens=8, prefill_token_budget=8)
POISSON = dict(seed=11, n_requests=6, mean_interarrival_ticks=2.0, prompt_lens=(8, 40),
               max_new_tokens=5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines run many small ops: one intra-op thread per test worker
    keeps parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jbase.reduced(jget_config("qwen2-7b")),
                               capacity_factor=100.0, **kw)
    cfg = dataclasses.replace(base.reduced(get_config("qwen2-7b")),
                              capacity_factor=100.0, **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _prompts(vocab, lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, int(n)).tolist() for n in lens]


def _serve(engine_cls, request_cls, cfg, params, serve, prompts, max_new=MAX_NEW, **kw):
    """Outputs, ``on_token`` calls and the engine after draining."""
    eng = engine_cls(cfg, params, serve=serve, **kw)
    stream = []
    for uid, prompt in enumerate(prompts):
        eng.submit(request_cls(uid, list(prompt), max_new_tokens=max_new,
                               on_token=lambda u, t: stream.append((u, t))))
    return dict(eng.run()), stream, eng


def _port(weights, prompts, max_new=MAX_NEW, **serve_kw):
    return _serve(ServeEngine, Request, weights[2], weights[3],
                  base.ServeConfig(**serve_kw), prompts, max_new, device="cpu")


def _jax(weights, prompts, max_new=MAX_NEW, **serve_kw):
    return _serve(JServeEngine, JRequest, weights[0], weights[1],
                  jbase.ServeConfig(**serve_kw), prompts, max_new)


@pytest.fixture(scope="module")
def two_phase(weights):
    """The JAX engine's whole-prompt two-phase outputs (paged; its
    lane-dense engine gives the same tokens, ``tests/test_paged_serve.py``)."""
    return _jax(weights, _prompts(weights[0].vocab_size), **BASE)[0]


# ==========================================================================
# Token identity: chunked == whole-prompt two-phase == token replay
# ==========================================================================
class TestChunkedIdentity:
    @pytest.mark.parametrize("paged", [True, False])
    @pytest.mark.parametrize("chunk", [8, 24])
    def test_matches_two_phase(self, weights, two_phase, paged, chunk):
        out, _, eng = _port(weights, _prompts(weights[0].vocab_size), **BASE,
                            paged=paged, chunked_prefill=True,
                            prefill_chunk_tokens=chunk)
        assert eng.stats()["mode"] == f"{'paged' if paged else 'dense'}+chunked-prefill"
        assert out == two_phase

    def test_matches_token_replay(self, weights, two_phase):
        prompts = _prompts(weights[0].vocab_size)
        replay, _, _ = _port(weights, prompts, **BASE, paged=False,
                             batched_prefill=False)
        chunked, _, _ = _port(weights, prompts, **BASE, chunked_prefill=True,
                              prefill_chunk_tokens=16)
        assert chunked == replay == two_phase

    @pytest.mark.parametrize("chunk", [16, 32])
    def test_ss_fused_stats_handoff(self, weights, two_phase, chunk, monkeypatch):
        """``prefill_impl`` routes only the stats handoff: chunk 16 = c
        recomputes, chunk 32 > c runs the K1 site (its plain version on the
        CPU), and the tokens stay the exact two-phase ones."""
        calls = []
        k1 = prefill.landmark_summary
        monkeypatch.setattr(prefill, "landmark_summary",
                            lambda *a, **kw: calls.append(kw["kv_valid"]) or k1(*a, **kw))
        out, _, _ = _port(weights, _prompts(weights[0].vocab_size), **BASE,
                          prefill_impl="ss_fused", chunked_prefill=True,
                          prefill_chunk_tokens=chunk)
        assert out == two_phase
        # K1 runs once per layer and chunk, and sees a ragged final chunk
        assert bool(calls) == (chunk > weights[2].num_landmarks)
        if calls:
            assert min(calls) < chunk

    def test_chunked_requires_batched_prefill(self):
        for cls in (base.ServeConfig, jbase.ServeConfig):
            with pytest.raises(ValueError):
                cls(max_lanes=1, max_seq=64, block_size=8, paged=False,
                    batched_prefill=False, chunked_prefill=True)


# ==========================================================================
# Preemption at chunk boundaries + parking
# ==========================================================================
class TestChunkedPreemption:
    def test_tight_pool_outputs_identical(self, weights):
        """A pool too small for all four requests preempts (parking
        mid-prefill, resuming at the chunk boundary): tokens and
        ``on_token`` calls are the JAX engine's on the same pool, and the
        uncontended two-phase tokens."""
        prompts = _prompts(weights[0].vocab_size, lens=(40, 48, 30, 20), seed=1)
        out, stream, eng = _port(weights, prompts, 10, **TIGHT)
        jout, jstream, jeng = _jax(weights, prompts, 10, **TIGHT)
        st, jst = eng.stats(), jeng.stats()
        assert out == jout and stream == jstream
        assert st["preemptions"] == jst["preemptions"] >= 1
        assert st["mode"] == jst["mode"]
        assert st["resume_ttft_s_p50"] is not None
        assert st["finished"] == jst["finished"] == 4
        ref, _, _ = _port(weights, prompts, 10, **BASE)
        assert out == ref

    def test_all_prefill_deadlock_breaks(self, weights):
        """Every lane stalled mid-prefill on a dry pool: the in-tick breaker
        preempts the youngest stalled prefill and the batch drains, with
        the JAX engine's tokens and preemptions."""
        prompts = _prompts(weights[0].vocab_size, lens=(40, 40, 40, 40), seed=2)
        out, stream, eng = _port(weights, prompts, **DEADLOCK)
        jout, jstream, jeng = _jax(weights, prompts, **DEADLOCK)
        assert len(out) == 4
        assert out == jout and stream == jstream
        assert eng.stats()["preemptions"] == jeng.stats()["preemptions"] >= 1
        ref, _, _ = _port(weights, prompts, **dict(DEADLOCK, num_blocks=0))
        assert out == ref

    @staticmethod
    def _park_after_first_chunk(engine_cls, request_cls, cfg, params, serve, prompts,
                                **kw):
        """Request 0 is preempted after its first chunk while the pool still
        has room (the scheduler's ``preempt``, as the reference's chaos
        ``drop_sample`` calls it), so it parks and is re-admitted with its
        blocks: outputs, ``on_token`` calls, the engine, and the parked
        uids (scheduler, engine) right after the preemption."""
        eng = engine_cls(cfg, params, serve=serve, **kw)
        stream = []
        for uid, prompt in enumerate(prompts):
            eng.submit(request_cls(uid, list(prompt), max_new_tokens=MAX_NEW,
                                   on_token=lambda u, t: stream.append((u, t))))
        eng.tick()
        lane = eng.sched.lane_uid.index(0)
        assert eng.lanes[lane].prefilling and eng.lanes[lane].prefill_pos > 0
        eng.sched.preempt(lane)
        parked = (list(eng.sched.parked), sorted(eng._parked))
        return dict(eng.run()), stream, eng, parked

    def test_parked_lane_resumes_at_its_chunk_boundary(self, weights):
        """The resume branch: the parked snapshot is restored and prefill
        goes on at the committed chunk boundary, with the JAX engine's
        tokens and ``on_token`` calls and the tokens of a run with no
        preemption."""
        jcfg, jparams, cfg, params = weights
        prompts = _prompts(cfg.vocab_size, lens=(40, 9), seed=4)
        serve = dict(BASE, chunked_prefill=True, prefill_chunk_tokens=8)
        out, stream, eng, parked = self._park_after_first_chunk(
            ServeEngine, Request, cfg, params, base.ServeConfig(**serve), prompts,
            device="cpu")
        jout, jstream, jeng, jparked = self._park_after_first_chunk(
            JServeEngine, JRequest, jcfg, jparams, jbase.ServeConfig(**serve), prompts)
        assert parked == jparked == ([0], [0])
        st = eng.stats()
        assert (st["parks"], st["parked_resumes"]) == (1, 1)
        assert st["preemptions"] == jeng.stats()["preemptions"] == 1
        assert not eng._parked and not jeng._parked
        assert out == jout and stream == jstream
        assert out == _port(weights, prompts, **serve)[0]

    @pytest.mark.parametrize("side", ["port", "jax"])
    def test_resume_ttft_routing(self, side):
        """The first token after a requeue counts as resume TTFT only, never
        as TTFT or ITL; the JAX scheduler's histograms count the same."""
        alloc_cls, sched_cls, req_cls = ((BlockAllocator, Scheduler, Request)
                                         if side == "port" else
                                         (JBlockAllocator, JScheduler, JRequest))
        sched = sched_cls(alloc_cls(17, 8), max_lanes=1, blocks_per_lane=8)
        req = req_cls(0, list(range(10)), max_new_tokens=4)
        sched.requeue_cb = lambda lane: req
        sched.submit(req)
        counts = []

        def read():  # both schedulers keep the reference's histograms
            return (sched._ttft_s.count, sched._resume_ttft_s.count,
                    sched._itl_s.count)

        assert sched.admit()
        sched.note_token(0)
        counts.append(read())
        sched.preempt(0)
        assert sched.timing[0].requeued_s is not None
        assert sched.admit()
        sched.note_token(0)   # first post-resume token
        counts.append(read())
        assert sched.timing[0].requeued_s is None
        sched.note_token(0)   # steady cadence resumes
        counts.append(read())
        assert counts == [(1, 0, 0), (1, 1, 0), (1, 1, 1)]


# ==========================================================================
# Starvation invariant: decode lanes survive a long-prompt flood
# ==========================================================================
class TestDecodeNeverStarves:
    @staticmethod
    def _flood(engine_cls, request_cls, serve_cls, cfg, params, **kw):
        rng = np.random.default_rng(3)
        eng = engine_cls(cfg, params, serve=serve_cls(**FLOOD), **kw)
        ticks: dict[int, list[int]] = {}
        tokens: dict[int, list[int]] = {}

        def on_tok(uid, tok):
            ticks.setdefault(uid, []).append(eng._tick)
            tokens.setdefault(uid, []).append(tok)

        eng.submit(request_cls(0, rng.integers(3, cfg.vocab_size, 8).tolist(),
                               max_new_tokens=30, on_token=on_tok))
        for _ in range(3):
            eng.tick()
        for u in range(1, 4):  # flood: long prompts chunk in behind it
            eng.submit(request_cls(u, rng.integers(3, cfg.vocab_size, 80).tolist(),
                                   max_new_tokens=4, on_token=on_tok))
        eng.run()
        return ticks, tokens

    def test_tick_gap_is_one_under_flood(self, weights):
        jcfg, jparams, cfg, params = weights
        ticks, tokens = self._flood(ServeEngine, Request, base.ServeConfig, cfg,
                                    params, device="cpu")
        gaps = np.diff(ticks[0])
        assert len(ticks[0]) == 30
        assert int(gaps.max()) == 1
        jticks, jtokens = self._flood(JServeEngine, JRequest, jbase.ServeConfig,
                                      jcfg, jparams)
        assert (ticks, tokens) == (jticks, jtokens)


# ==========================================================================
# Deterministic Poisson workload replay
# ==========================================================================
class TestPoissonReplay:
    def test_trace_is_seed_deterministic(self):
        kw = dict(n_requests=10, mean_interarrival_ticks=2.0, prompt_lens=(8, 40),
                  vocab_size=1000)
        assert workload.poisson_trace(seed=5, **kw) == workload.poisson_trace(seed=5, **kw)
        assert workload.poisson_trace(seed=5, **kw) != workload.poisson_trace(seed=6, **kw)
        # the port's copy draws the reference's trace
        for seed in (5, 6):
            ours = workload.poisson_trace(seed=seed, **kw)
            ref = jworkload.poisson_trace(seed=seed, **kw)
            assert [dataclasses.astuple(it) for it in ours] == [
                dataclasses.astuple(it) for it in ref]

    def test_replay_outputs_identical(self, weights):
        jcfg, jparams, cfg, params = weights
        serve = dict(BASE, chunked_prefill=True, prefill_chunk_tokens=8)
        trace = workload.poisson_trace(vocab_size=cfg.vocab_size, **POISSON)
        outs = []
        for _ in range(2):
            eng = ServeEngine(cfg, params, serve=base.ServeConfig(**serve), device="cpu")
            m = workload.latency_metrics(workload.replay_trace(eng, trace))
            assert m["n_requests"] == 6 and m["itl_p99_s"] is not None
            outs.append(dict(eng.finished))
        assert outs[0] == outs[1]
        assert sorted(outs[0]) == [it.uid for it in trace]
        jeng = JServeEngine(jcfg, jparams, serve=jbase.ServeConfig(**serve))
        jworkload.replay_trace(jeng, jworkload.poisson_trace(
            vocab_size=jcfg.vocab_size, **POISSON))
        assert outs[0] == dict(jeng.finished)


# ==========================================================================
# Layer level: the stats carry and the chunk step against the reference
# ==========================================================================
def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("stats_impl,start,chunk_valid", [
    ("ss_fused", 32, 19), ("ss_fused", 0, 32), ("replay", 24, 24)])
def test_merge_chunk_stats_matches_jax(stats_impl, start, chunk_valid):
    """Random carry, landmark means and keys; chunk_pad 32 > c = 16, so
    ``ss_fused`` runs K1 (port: plain version; JAX: the Pallas kernel,
    interpreted) with ``kv_valid = chunk_valid``; frozen rows merge, the
    moved span recomputes, later rows are zero."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(7)
    b, h, c, d, pad, seq_max = 1, 4, jcfg.num_landmarks, 32, 32, 64
    carry = (rng.normal(size=(b, h, c, 1)), rng.uniform(1, 4, (b, h, c, 1)),
             rng.normal(size=(b, h, c, d)))
    q_l = rng.normal(size=(b, h, c, d)) * 0.5
    k_full = rng.normal(size=(b, h, start + pad, d)) * 0.5
    v_full = rng.normal(size=(b, h, start + pad, d))
    k_full[:, :, start + chunk_valid:] = 0
    v_full[:, :, start + chunk_valid:] = 0
    kb, vb = k_full[:, :, start:], v_full[:, :, start:]
    arrays = [np.asarray(x, np.float32) for x in (*carry, q_l, kb, vb, k_full, v_full)]
    scale = d ** -0.5
    ref = jprefill._merge_chunk_stats(
        jcfg, stats_impl, tuple(jnp.asarray(x) for x in arrays[:3]),
        *(jnp.asarray(x) for x in arrays[3:]), start, chunk_valid, scale, seq_max,
        512)
    got = prefill._merge_chunk_stats(
        cfg, stats_impl, tuple(torch.from_numpy(x) for x in arrays[:3]),
        *(torch.from_numpy(x) for x in arrays[3:]), start, chunk_valid, scale, seq_max)
    for name, g, r in zip(("m", "l", "acc"), got, ref):
        assert _rel(g.numpy(), r) <= 1e-5, name


@pytest.mark.parametrize("layers,tol", [(1, 5e-5), (2, 5e-4)])
def test_chunk_prefill_matches_jax(layers, tol):
    """Two consecutive chunks of one prompt (32 tokens, then a ragged 19 of
    32) under ``stats_impl="ss_fused"``, each side fed its own previous
    chunk: logits within ``tol`` of max-abs (positions whose context fills
    only 2-4 landmark rows within 5e-4, as in ``tests/test_torch_model.py``:
    ROADMAP P2), the stats carry within 1e-5 at 1 layer (``tol`` at 2), K/V
    and landmark sums within ``tol``."""
    jcfg, cfg = _cfgs(num_layers=layers)
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    seq_max, pad = 64, 32
    toks = np.random.default_rng(8).integers(3, cfg.vocab_size, 51)
    zero = jprefill._zero_cache(jcfg, 0)["layers"]
    jlayers = dict(zero)
    layers_t = {k: torch.from_numpy(np.array(v)) for k, v in zero.items()}
    stats_tol = 1e-5 if layers == 1 else tol
    for start, cv in ((0, 32), (32, 19)):
        chunk = np.zeros((1, pad), np.int32)
        chunk[0, :cv] = toks[start:start + cv]
        jl, jc = jprefill.chunk_prefill(jparams, jcfg, {"layers": jlayers},
                                        jnp.asarray(chunk), start, cv, seq_max=seq_max,
                                        stats_impl="ss_fused")
        lg, pc = prefill.chunk_prefill(params, cfg, {"layers": layers_t},
                                       torch.from_numpy(chunk).long(), start, cv,
                                       seq_max=seq_max, stats_impl="ss_fused")
        # P2 (ROADMAP Queue 3): a position whose context fills only 2-4 of
        # the c landmark rows has a rounding-level delta_ss on both sides
        live = (start + np.arange(cv)) // (seq_max // cfg.num_landmarks) + 1
        g, r = lg[0, :cv].numpy(), np.asarray(jl)[0, :cv]
        err = np.abs(g - r).max(-1) / np.abs(r).max()
        assert err[live > 4].max() <= tol
        assert err.max() <= max(tol, 5e-4)
        for name in ("bv_m", "bv_l", "bv_acc"):
            assert _rel(pc["layers"][name].numpy(), jc["layers"][name]) <= stats_tol, name
        for name in ("k", "v", "q_lmk", "k_lmk"):
            assert _rel(pc["layers"][name].numpy(), jc["layers"][name]) <= tol, name
        # the next chunk sees this one's K/V committed after the earlier ones
        jlayers = {name: (jnp.concatenate([jlayers[name], jc["layers"][name][..., :cv, :]],
                                          axis=3) if name in ("k", "v")
                          else jc["layers"][name]) for name in jlayers}
        layers_t = {name: (torch.cat([layers_t[name], pc["layers"][name][..., :cv, :]], 3)
                           if name in ("k", "v") else pc["layers"][name])
                    for name in layers_t}
