"""The port's frozen streaming decode (boundary rebase) and block-pool
defragmentation against the JAX reference, on the CPU.

* Layer level, fp32, numpy-seeded inputs: the frozen step of
  ``ss_decode_attention_streaming``, ``rebase_rows`` and the rebase walk
  (``make_rebase_fn``; ``rebase_streaming`` in the reference) against the
  reference's functions, per lane, within 1e-5 of max-abs.
* ``test_frozen_boundary_rebase_correctness`` replayed on the port's
  engine: after boundary rebases every frozen row's BV equals the exact
  recompute over the lane's keys (2e-4, the reference's tolerance).
* The engine: greedy tokens, ``on_token`` calls and ``stats()["rebases"]``
  identical to the JAX engine's under ``decode_streaming="frozen"``, with
  the prefill route held fixed on both sides (frozen state depends on it
  by design): ss_fused and replay prefill each with paged and gather
  decode, lane-dense storage (batched and token replay), the chunked
  tick, a preempting pool, and the prefix cache's warm == cold in both
  attach modes. A frozen tick never calls K5's wrapper; a demoted lane
  does.
* Defragmentation: the port's allocator (and prefix cache) driven through
  the same calls as the reference's end in the same mapping, tables,
  refcounts, free list and entries (``test_defragment_pins_shared_blocks``
  among them); ``scramble_free`` shuffles as the reference's does;
  ``apply_mapping`` moves overlapping chains of blocks; the engine
  defragmenting between ticks moves the same blocks as the JAX engine and
  leaves every token unchanged.
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
from repro.serve import decode_state as jds  # noqa: E402
from repro.serve import paged as jpaged  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.attention import _broadcast_kv  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serve import decode as decode_mod  # noqa: E402
from repro_torch.serve import decode_state as ds  # noqa: E402
from repro_torch.serve import paged  # noqa: E402
from repro_torch.serve.chaos import FaultPlan, FaultRule  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

BASE = dict(max_lanes=2, max_seq=64, block_size=8)
PROMPT_LENS = (37, 9, 24, 50)   # c = 16, seg = 4: many boundaries each
MAX_NEW = 12
# route: ServeConfig fields, the prompts' lengths and new tokens
ROUTES = {
    "ss_fused_paged": (dict(prefill_impl="ss_fused", decode_impl="paged"), PROMPT_LENS,
                       MAX_NEW),
    "ss_fused_gather": (dict(prefill_impl="ss_fused"), PROMPT_LENS, MAX_NEW),
    "replay_paged": (dict(decode_impl="paged"), PROMPT_LENS, MAX_NEW),
    "replay_gather": ({}, PROMPT_LENS, MAX_NEW),
    "lane_dense": (dict(paged=False, prefill_impl="ss_fused"), PROMPT_LENS, MAX_NEW),
    "lane_dense_token_replay": (dict(paged=False, batched_prefill=False), (21, 9),
                                MAX_NEW),
    # chunk 32 > c: the ss_fused stats handoff (K1's site)
    "chunked": (dict(chunked_prefill=True, prefill_chunk_tokens=32,
                     prefill_impl="ss_fused", decode_impl="paged"), PROMPT_LENS, MAX_NEW),
    "preempting_pool": (dict(max_lanes=3, num_blocks=12, prefill_impl="ss_fused",
                             decode_impl="paged"), (20, 20, 20, 20), 30),
}
TOL = 1e-5


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
                               capacity_factor=100.0, decode_streaming="frozen")
    cfg = dataclasses.replace(base.reduced(get_config("qwen2-7b")),
                              capacity_factor=100.0, decode_streaming="frozen")
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ==========================================================================
# Layer level
# ==========================================================================
def _layer_inputs(cfg, lanes=2, seq_max=64, seed=0):
    """numpy-seeded inputs of one layer's streaming state, per lane. The
    landmark sums have scale 0.5: with much larger ones the random-weight
    c x c core is ill-conditioned and its iterative pseudoinverse
    amplifies fp32 rounding (ROADMAP P1): at scale 3 the two step outputs
    differ by up to 5e-4 of max-abs while the stats still agree to 3e-7."""
    rng = np.random.default_rng(seed)
    h, hkv, d, c = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                    cfg.num_landmarks)

    def rnd(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    return dict(
        q=rnd(lanes, h, 1, d), k_new=rnd(lanes, hkv, d), v_new=rnd(lanes, hkv, d),
        k=rnd(lanes, hkv, seq_max, d), v=rnd(lanes, hkv, seq_max, d),
        q_lmk=rnd(lanes, h, c, d, s=0.5), k_lmk=rnd(lanes, hkv, c, d, s=0.5),
        bv_m=rnd(lanes, h, c, 1), bv_l=rng.uniform(0.5, 2.0, (lanes, h, c, 1)).astype(
            np.float32), bv_acc=rnd(lanes, h, c, d))


def test_frozen_streaming_step_matches_reference(weights):
    """The frozen step (no active-row hook, no horizon) at two lanes with
    their own positions: output and stats per lane within 1e-5."""
    jcfg, _, cfg, _ = weights
    seq_max, pos = 64, np.array([13, 40])
    x = _layer_inputs(cfg, seq_max=seq_max)
    h, scale = cfg.num_heads, cfg.resolved_head_dim ** -0.5
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    k_lmk = _broadcast_kv(t["k_lmk"], h)
    out, stats = ds.ss_decode_attention_streaming(
        t["q"], _broadcast_kv(t["k_new"][:, :, None], h)[:, :, 0],
        _broadcast_kv(t["v_new"][:, :, None], h)[:, :, 0], t["q_lmk"], k_lmk,
        (t["bv_m"], t["bv_l"], t["bv_acc"]), torch.from_numpy(pos), cfg, scale,
        seq_max)
    for b in range(2):
        kb = np.repeat(x["k_new"][b:b + 1], h // cfg.num_kv_heads, axis=1)
        vb = np.repeat(x["v_new"][b:b + 1], h // cfg.num_kv_heads, axis=1)
        jout, jstats = jds.ss_decode_attention_streaming(
            jnp.asarray(x["q"][b:b + 1]), jnp.asarray(kb), jnp.asarray(vb), None, None,
            jnp.asarray(x["q_lmk"][b:b + 1]), jnp.asarray(k_lmk[b:b + 1].numpy()),
            tuple(jnp.asarray(x[n][b:b + 1]) for n in ds.STREAM_LEAVES),
            jnp.asarray(int(pos[b])), jcfg, scale, seq_max=seq_max, mode="frozen")
        assert _rel(out[b:b + 1], jout) < TOL
        for ours, ref in zip(stats, jstats):
            assert _rel(ours[b:b + 1], ref) < TOL


def test_rebase_rows_matches_reference(weights):
    """Two rows over keys 0..pos, the query heads grouped onto the kv
    heads here and broadcast in the reference."""
    _, _, cfg, _ = weights
    x = _layer_inputs(cfg, lanes=1, seed=1)
    h, pos, scale = cfg.num_heads, 29, cfg.resolved_head_dim ** -0.5
    rows = np.array([6, 7])
    q_l = x["q_lmk"] / 5.0
    stats = tuple(x[n] for n in ds.STREAM_LEAVES)
    ours = ds.rebase_rows(tuple(map(torch.from_numpy, stats)), torch.from_numpy(q_l),
                          torch.from_numpy(x["k"]), torch.from_numpy(x["v"]), pos, scale,
                          torch.from_numpy(rows))
    ref = jds.rebase_rows(tuple(map(jnp.asarray, stats)), jnp.asarray(q_l),
                          jnp.asarray(np.repeat(x["k"], h // cfg.num_kv_heads, axis=1)),
                          jnp.asarray(np.repeat(x["v"], h // cfg.num_kv_heads, axis=1)),
                          jnp.asarray(pos), scale, jnp.asarray(rows))
    for a, b in zip(ours, ref):
        assert _rel(a, b) < TOL
    # the other rows pass through untouched
    keep = np.setdiff1d(np.arange(cfg.num_landmarks), rows)
    for a, b in zip(ours, stats):
        assert np.array_equal(a.numpy()[:, :, keep], b[:, :, keep])


def test_rebase_walk_matches_reference(weights):
    """``make_rebase_fn`` over one layer at two lanes, each at its own
    boundary, against ``rebase_streaming`` per lane."""
    jcfg, _, cfg, _ = weights
    seq_max, pos = 64, np.array([8, 36])    # seg 4: boundaries
    x = _layer_inputs(cfg, seq_max=seq_max, seed=2)
    names = ("k", "v", "q_lmk", "k_lmk", *ds.STREAM_LEAVES)
    (lc,) = ds.make_rebase_fn(cfg, seq_max)([{n: torch.from_numpy(x[n]) for n in names}],
                                             torch.from_numpy(pos))
    for b in range(2):
        jcache = {"layers": [{n: jnp.asarray(x[n][b:b + 1]) for n in names}]}
        (jlc,) = jds.rebase_streaming(jcfg, jcache, jnp.asarray(int(pos[b])),
                                      seq_max=seq_max)["layers"]
        for n in ds.STREAM_LEAVES:
            assert _rel(lc[n][b:b + 1], jlc[n]) < TOL, n


def test_frozen_boundary_rebase_correctness(weights):
    """``tests/test_paged_serve.py::test_frozen_boundary_rebase_correctness``
    on the port's engine: a 20-token prompt fed one token per tick (max_seq
    48, seg 3) with the engine's boundary rebases; every frozen row's BV
    then equals the exact recompute over the lane's keys; only the active
    row may drift."""
    _, _, cfg, params = weights
    s_max, n = 48, 20
    prompt = np.random.default_rng(25).integers(3, cfg.vocab_size, n).tolist()
    eng = ServeEngine(cfg, params, device="cpu", serve=base.ServeConfig(
        max_lanes=1, max_seq=s_max, block_size=8, paged=False, batched_prefill=False))
    eng.submit(Request(0, prompt, max_new_tokens=1))
    eng.run()
    seg = ds.segment_len(s_max, cfg.num_landmarks)
    assert eng.stats()["rebases"] == len(range(seg, n, seg))
    st = {name: t[0] for name, t in eng.kv.storage.items()}   # layer 0, (lanes, ...)
    pos = torch.tensor([n - 1])
    counts = ds.landmark_counts(pos, s_max, cfg.num_landmarks)
    m, l, acc = ds.recompute_stats(
        ds.landmark_means(st["q_lmk"], counts), _broadcast_kv(st["k"], cfg.num_heads),
        _broadcast_kv(st["v"], cfg.num_heads), pos, cfg.resolved_head_dim ** -0.5,
        row_valid=counts > 0)
    active = (n - 1) // seg
    assert active >= 2, "the check needs several frozen segments"
    bv_ref = (acc / torch.clamp(l, min=1e-30))[:, :, :active]
    bv_got = (st["bv_acc"] / torch.clamp(st["bv_l"], min=1e-30))[:, :, :active]
    np.testing.assert_allclose(bv_got.numpy(), bv_ref.numpy(), atol=2e-4, rtol=2e-4)


# ==========================================================================
# The engine against the JAX engine
# ==========================================================================
def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(3, vocab, size=n).tolist()) for uid, n in enumerate(lens)]


def _run(engine_cls, request_cls, cfg, params, serve, prompts, max_new, **kw):
    eng = engine_cls(cfg, params, serve=serve, **kw)
    stream = []
    for uid, prompt in prompts:
        eng.submit(request_cls(uid, list(prompt), max_new_tokens=max_new,
                               on_token=lambda u, t: stream.append((u, t))))
    return eng.run(), stream, eng


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_frozen_tokens_identical_to_jax_engine(weights, route):
    jcfg, jparams, cfg, params = weights
    serve_kw, lens, max_new = ROUTES[route]
    serve_kw = dict(BASE, **serve_kw)
    prompts = _prompts(cfg.vocab_size, lens)
    out, stream, eng = _run(ServeEngine, Request, cfg, params,
                            base.ServeConfig(**serve_kw), prompts, max_new, device="cpu")
    jout, jstream, jeng = _run(JServeEngine, JRequest, jcfg, jparams,
                               jbase.ServeConfig(**serve_kw), prompts, max_new)
    assert sorted(out) == [uid for uid, _ in prompts]
    assert out == jout and stream == jstream
    st, jst = eng.stats(), jeng.stats()
    assert st["rebases"] == jst["rebases"] > 0
    for key in ("mode", "decode_impl", "decode_streaming", "preemptions"):
        assert st[key] == jst[key], key
    assert (st["preemptions"] > 0) == (route == "preempting_pool")


@pytest.mark.parametrize("attach", ["reseg", "recompute"])
def test_prefix_warm_equals_cold_frozen(weights, attach):
    """The frozen half of ``test_streaming_modes_warm_equals_cold``: a warm
    full hit reproduces the cold run's tokens, on the port as on the JAX
    engine."""
    jcfg, jparams, cfg, params = weights
    prefix = dict(BASE, prefix_cache=True, prefill_chunk_tokens=16, prefix_attach=attach)
    cold = dict(prefix, prefix_cache=False, chunked_prefill=True)
    p = np.random.default_rng(56).integers(3, cfg.vocab_size, 37).tolist()

    def seq(engine_cls, request_cls, c, pp, serve, **kw):
        eng = engine_cls(c, pp, serve=serve, **kw)
        out, stream = {}, []
        for uid in range(2):
            eng.submit(request_cls(uid, list(p), max_new_tokens=8,
                                   on_token=lambda u, t: stream.append((u, t))))
            out.update(eng.run())
        return out, stream, eng.stats()

    out, stream, st = seq(ServeEngine, Request, cfg, params, base.ServeConfig(**prefix),
                          device="cpu")
    ref, _, _ = seq(ServeEngine, Request, cfg, params, base.ServeConfig(**cold),
                    device="cpu")
    jout, jstream, jst = seq(JServeEngine, JRequest, jcfg, jparams,
                             jbase.ServeConfig(**prefix))
    assert out == ref
    assert out == jout and stream == jstream
    assert st["prefix"]["hits"] == jst["prefix"]["hits"] == 1
    assert st["rebases"] == jst["rebases"]


def test_frozen_tick_never_calls_k5(weights, monkeypatch):
    """K5's wrapper is not called on a frozen paged tick, exact is (every
    decode tick, every layer), and a lane demoted by the guard calls it."""
    _, _, cfg, params = weights
    calls = []
    k5 = decode_mod.paged_row_stats_lanes
    monkeypatch.setattr(decode_mod, "paged_row_stats_lanes",
                        lambda *a, **kw: calls.append(1) or k5(*a, **kw))
    serve = base.ServeConfig(**BASE, prefill_impl="ss_fused", decode_impl="paged",
                             numerics_guard=True)
    prompts = _prompts(cfg.vocab_size, (37, 9))

    def run(c, plan=None):
        calls.clear()
        eng = ServeEngine(c, params, serve=serve, device="cpu", chaos=plan)
        for uid, prompt in prompts:
            eng.submit(Request(uid, prompt, max_new_tokens=MAX_NEW))
        eng.run()
        return len(calls), eng.stats()

    n, st = run(cfg)
    assert n == 0 and st["rebases"] > 0
    n, st = run(dataclasses.replace(cfg, decode_streaming="exact"))
    assert n == st["decode_ticks"] * cfg.num_layers
    n, st = run(cfg, FaultPlan(rules=(FaultRule("nan_stats", lane=0, start_tick=3,
                                                end_tick=4),)))
    assert st["demotions"] == 1 and n > 0


# ==========================================================================
# Defragmentation
# ==========================================================================
SIDES = {"port": paged, "jax": jpaged}


def _state(a):
    return a.tables, a.refcounts, a._free


def _same(fn):
    """``fn(module)`` on the port's module and the reference's: both pass
    their asserts and return equal values."""
    ours, ref = fn(paged), fn(jpaged)
    assert ours == ref
    return ours


def test_defragment_compacts_and_remaps():
    def case(m):
        a = m.BlockAllocator(17, 8)
        a.alloc(1, 3)
        a.alloc(2, 4)
        a.alloc(3, 2)
        a.free(2)  # a hole in the middle
        mapping = a.defragment()
        assert sorted(b for t in a.tables.values() for b in t) == list(range(1, 6))
        assert m.ZERO_BLOCK not in mapping and m.ZERO_BLOCK not in mapping.values()
        assert a.num_free == 16 - 5
        return mapping, _state(a)
    _same(case)


def test_defragment_pins_shared_blocks():
    def case(m):
        a = m.BlockAllocator(17, 8)
        a.alloc(1, 3)  # blocks 1..3
        a.alloc(2, 4)  # blocks 4..7
        pinned = a.tables[2][3]  # block 7
        a.take_ref(pinned)  # rc 2: shared, must not move
        a.free(1)  # hole at 1..3
        mapping = a.defragment()
        assert pinned not in mapping and pinned not in mapping.values()
        assert a.tables[2] == [1, 2, 3, pinned]
        assert a.refcount(pinned) == 2
        return mapping, _state(a)
    _same(case)


def test_defragment_remaps_prefix_entries():
    """Singly-held cache blocks move and their entries follow; a block an
    entry shares with a live table stays pinned."""
    def case(m):
        a = m.BlockAllocator(33, 4)
        pc = m.PrefixCache(a)
        a.alloc(0, 3)
        a.alloc(1, 5)
        a.alloc(2, 4)
        pc.insert(list(range(20)), a.tables[1], logits=np.zeros(4))
        a.free(0)
        a.free(1)          # entry now the sole holder of its blocks
        a.scramble_free(5)
        a.alloc(3, 6)      # lands on scattered ids
        mapping = a.defragment()
        assert mapping
        return (mapping, _state(a), [e.blocks for e in pc._entries], pc._cache_refs,
                pc.match(list(range(20)))[1])
    _same(case)


@pytest.mark.parametrize("key", [0, 7, -3])
def test_scramble_free_matches_reference(key):
    def case(m):
        a = m.BlockAllocator(40, 8)
        a.alloc(1, 5)
        a.free(1)
        a.scramble_free(key)
        return _state(a)
    _same(case)


def test_apply_mapping_moves_overlapping_chains(weights):
    """A chain (5 -> 2, 7 -> 5, 9 -> 7): every destination takes its
    source's OLD rows; block 0 and blocks outside the mapping stay."""
    _, _, cfg, _ = weights
    kv = paged.PagedKVCache(cfg, base.ServeConfig(**BASE), "cpu")
    gen = torch.Generator().manual_seed(0)
    for name in kv.pool_names:
        pool = kv.storage[name]
        pool.copy_(torch.randn(pool.shape, generator=gen))
        pool[:, :, paged.ZERO_BLOCK] = 0
    before = {name: kv.storage[name].clone() for name in kv.pool_names}
    mapping = {5: 2, 7: 5, 9: 7}
    kv.apply_mapping(mapping)
    for name in kv.pool_names:
        pool = kv.storage[name]
        for old, new in mapping.items():
            assert torch.equal(pool[:, :, new], before[name][:, :, old])
        for b in (0, 1, 3, 9):
            assert torch.equal(pool[:, :, b], before[name][:, :, b])


def test_defragment_mid_stream(weights):
    """Defragmenting between ticks (with the chaos ``fragment`` site
    scattering the free list) moves the same blocks as the JAX engine and
    changes no token: frozen streaming, paged decode."""
    jcfg, jparams, cfg, params = weights
    serve_kw = dict(BASE, prefill_impl="ss_fused", decode_impl="paged")
    prompts = _prompts(cfg.vocab_size, (37, 9, 24, 50, 16), seed=8)

    def run(engine_cls, request_cls, c, pp, serve, plan, defrag, **kw):
        eng = engine_cls(c, pp, serve=serve, chaos=plan, **kw)
        for uid, prompt in prompts:
            eng.submit(request_cls(uid, list(prompt), max_new_tokens=MAX_NEW))
        moved = []
        while not eng.sched.idle:
            eng.tick()
            if defrag:
                moved.append(eng.defragment())
        return eng.finished, moved

    def plan(m):
        return m.FaultPlan(seed=1, rules=(m.FaultRule("fragment", rate=0.5),))

    from repro.serve import chaos as jchaos
    from repro_torch.serve import chaos
    out, moved = run(ServeEngine, Request, cfg, params, base.ServeConfig(**serve_kw),
                     plan(chaos), True, device="cpu")
    ref, _ = run(ServeEngine, Request, cfg, params, base.ServeConfig(**serve_kw),
                 None, False, device="cpu")
    jout, jmoved = run(JServeEngine, JRequest, jcfg, jparams,
                       jbase.ServeConfig(**serve_kw), plan(jchaos), True)
    assert out == ref == jout
    assert moved == jmoved and sum(moved) > 0
