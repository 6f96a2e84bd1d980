"""The port's prefix cache (refcounted copy-on-write blocks, the chained
content-hash index, landmark-sum re-segmentation, the engine's attach
paths) against the JAX reference, on the CPU.

The oracles of ``tests/test_prefix_cache.py`` replayed on the port:
the allocator's refcount invariants and cascade eviction (the port's
allocator and cache driven through the same calls as the reference's end
in the same tables, refcounts and free list); SHA-1 block digests equal
to the reference's; ``resegment_sums`` against the reference's; and the
engine: aligned full hit, unaligned full hit with copy-on-write, partial
hit resuming chunked prefill, the flag inert on lane-dense storage, both
``prefix_attach`` modes, and a preempt-requeue that re-attaches. Each
engine case runs the port's engine and the JAX engine on the same
requests, one after another to completion: greedy tokens and ``on_token``
calls identical, the same ``stats()["prefix"]`` hits, misses and entries,
and the same ``cow_copies`` and preemptions; the warm tokens also equal a
cold chunked run of the port. Frozen streaming (the reference's other
half of the attach-mode test) and allocator defragmentation are in
``tests/test_torch_frozen.py``; the telemetry case (the prefix registry
counters, ``prefix_attach`` and ``cow`` lifeline events, a valid trace)
is in ``tests/test_torch_telemetry_engine.py``.
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
from repro.serve import paged as jpaged  # noqa: E402
from repro.serve.decode_state import resegment_sums as jresegment_sums  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serve import paged  # noqa: E402
from repro_torch.serve.decode_state import resegment_sums  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import Scheduler  # noqa: E402

BASE = dict(max_lanes=2, max_seq=64, block_size=8)
# small chunks, so multi-chunk prefills leave stat points to resume at
PREFIX = dict(BASE, prefix_cache=True, prefill_chunk_tokens=16)
COLD = dict(PREFIX, prefix_cache=False, chunked_prefill=True)


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
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(3, vocab, n).tolist()


def _serve_seq(engine_cls, request_cls, cfg, params, serve, prompts, max_new=8, **kw):
    """One engine; each prompt runs to completion before the next is
    submitted. Returns (outputs, on_token calls, engine)."""
    eng = engine_cls(cfg, params, serve=serve, **kw)
    out, stream = {}, []
    for uid, p in enumerate(prompts):
        eng.submit(request_cls(uid, list(p), max_new_tokens=max_new,
                               on_token=lambda u, t: stream.append((u, t))))
        out.update(eng.run())
    return out, stream, eng


def _both(weights, serve_kw, prompts):
    """The port's engine and the JAX engine on the same sequence; tokens
    and on_token calls must agree. Returns (port stats, JAX stats, outputs)."""
    jcfg, jparams, cfg, params = weights
    out, stream, eng = _serve_seq(ServeEngine, Request, cfg, params,
                                  base.ServeConfig(**serve_kw), prompts, device="cpu")
    jout, jstream, jeng = _serve_seq(JServeEngine, JRequest, jcfg, jparams,
                                     jbase.ServeConfig(**serve_kw), prompts)
    assert out == jout
    assert stream == jstream
    st, jst = eng.stats(), jeng.stats()
    assert st["mode"] == jst["mode"]
    assert st["cow_copies"] == jst["cow_copies"]
    assert st["preemptions"] == jst["preemptions"]
    assert ("prefix" in st) == ("prefix" in jst)
    if "prefix" in st:
        for key in ("hits", "misses", "entries", "blocks", "index_keys", "evictions"):
            assert st["prefix"][key] == jst["prefix"][key], key
    return st, jst, out


def _cold(weights, serve_kw, prompts):
    return _serve_seq(ServeEngine, Request, weights[2], weights[3],
                      base.ServeConfig(**serve_kw), prompts, device="cpu")[0]


# ==========================================================================
# Allocator refcount invariants, each run on both allocators
# ==========================================================================
def _check_invariant(a):
    """Every non-zero block is exactly one of: free, or held at rc >= 1."""
    free, held = set(a._free), set(a.refcounts)
    assert not (free & held), "block simultaneously free and referenced"
    assert len(a._free) == len(free), "duplicate id on the free list"
    assert free | held | {paged.ZERO_BLOCK} == set(range(a.num_blocks))
    assert all(rc >= 1 for rc in a.refcounts.values())


def _state(a):
    return a.tables, a.refcounts, a._free


SIDES = {"port": paged, "jax": jpaged}


def _same(fn):
    """Run ``fn(module)`` on the port's module and the reference's; both
    must pass their asserts and end in the same allocator state."""
    ours, ref = fn(paged), fn(jpaged)
    assert _state(ours) == _state(ref)


class TestRefcountedAllocator:
    def test_shared_block_survives_free(self):
        def case(m):
            a = m.BlockAllocator(9, 8)
            got = a.alloc(1, 3)
            a.take_ref(got[1])  # simulate cache retention
            freed = a.free(1)
            assert got[1] not in freed and got[1] not in a._free
            assert a.refcount(got[1]) == 1
            _check_invariant(a)
            assert a.release_ref(got[1]) is True  # last holder frees it
            assert a.num_free == 8
            _check_invariant(a)
            return a
        _same(case)

    @pytest.mark.parametrize("side", sorted(SIDES))
    def test_take_ref_on_free_block_raises(self, side):
        with pytest.raises(ValueError):
            SIDES[side].BlockAllocator(9, 8).take_ref(3)

    def test_attach_shared_prepends_and_cow_breaks_sharing(self):
        def case(m):
            a = m.BlockAllocator(17, 8)
            owner = a.alloc(1, 3)
            a.attach_shared(2, owner)
            assert a.tables[2] == owner
            assert [a.refcount(b) for b in owner] == [2, 2, 2]
            a.alloc(2, 1)  # tail grows past the shared span
            assert a.tables[2][:3] == owner and len(a.tables[2]) == 4
            old, new = a.cow(2, 1)
            assert (old, new) == (owner[1], a.tables[2][1])
            assert new != old and a.refcount(old) == 1 and a.refcount(new) == 1
            assert a.tables[1] == owner  # the other holder's view is untouched
            _check_invariant(a)
            a.free(2)
            a.free(1)
            assert a.num_free == 16
            _check_invariant(a)
            return a
        _same(case)

    def test_pool_pressure_evicts_cache_only_entries(self):
        def case(m):
            a = m.BlockAllocator(9, 4)  # 8 usable
            pc = m.PrefixCache(a)
            a.alloc(0, 4)
            pc.insert(list(range(16)), a.tables[0], logits=np.zeros(4))
            # owner still maps the blocks (rc 2): not reclaimable
            assert a.alloc(1, 5) is None
            assert pc.stats()["evictions"] == 0 and a.num_free == 4
            a.free(0)  # cache becomes sole holder (rc 1): reclaimable
            assert a.can_alloc(6)
            got = a.alloc(1, 6)  # shortfall LRU-evicts the entry mid-alloc
            assert got is not None and len(got) == 6
            st = pc.stats()
            assert st["evictions"] == 1 and st["entries"] == 0
            _check_invariant(a)
            return a
        _same(case)

    def test_overlapping_entries_cascade_evict_under_pressure(self):
        def case(m):
            a = m.BlockAllocator(9, 4)
            pc = m.PrefixCache(a)
            p = list(range(8))  # 2 full blocks
            a.alloc(0, 2)
            e1 = pc.insert(p, a.tables[0], logits=np.zeros(4))
            a.attach_shared(1, e1.blocks)
            a.alloc(1, 2)
            e2 = pc.insert(p + list(range(50, 58)), a.tables[1], logits=np.zeros(4))
            assert e2 is not None and e2.blocks[:2] == e1.blocks
            a.free(0)
            a.free(1)
            assert [a.refcount(b) for b in e1.blocks] == [2, 2]
            assert pc.evictable_blocks() == 4  # distinct, not double-counted
            assert a.can_alloc(8)
            got = a.alloc(2, 8)  # shortfall cascades through both entries
            assert got is not None and len(got) == 8
            st = pc.stats()
            assert st["entries"] == 0 and st["evictions"] == 2
            assert pc._cache_refs == {}
            _check_invariant(a)
            return a
        _same(case)

    def test_cascade_respects_live_extension_holder(self):
        def case(m):
            a = m.BlockAllocator(9, 4)
            pc = m.PrefixCache(a)
            p = list(range(8))
            a.alloc(0, 2)
            e1 = pc.insert(p, a.tables[0], logits=np.zeros(4))
            a.attach_shared(1, e1.blocks)
            a.alloc(1, 2)
            pc.insert(p + list(range(50, 58)), a.tables[1], logits=np.zeros(4))
            a.free(0)  # uid 1 still live and maps all four blocks
            assert pc.evictable_blocks() == 0
            assert a.alloc(2, 5) is None
            assert set(a.tables[1]).isdisjoint(a._free)
            assert pc.stats()["evictions"] == 0
            _check_invariant(a)
            return a
        _same(case)

    def test_probe_pin_is_soft_and_deprioritized(self):
        def case(m):
            a = m.BlockAllocator(9, 4)
            pc = m.PrefixCache(a)
            a.alloc(0, 2)
            e1 = pc.insert(list(range(8)), a.tables[0], logits=np.zeros(4))
            a.alloc(1, 2)
            e2 = pc.insert(list(range(50, 58)), a.tables[1], logits=np.zeros(4))
            a.free(0)
            a.free(1)
            pc.pin(e1)
            pc.touch(e2)  # e2 is now MRU: plain LRU would pick e1 first
            assert a.alloc(2, 6) is not None  # needs 2 evicted blocks
            assert e1 in pc._entries and e2 not in pc._entries
            assert a.alloc(3, 2) is not None  # only the pinned entry remains
            assert pc.stats()["entries"] == 0
            _check_invariant(a)
            return a
        _same(case)


# ==========================================================================
# Content hashing + index
# ==========================================================================
class TestPrefixHashing:
    def test_chained_digests_fingerprint_whole_prefix(self):
        p = list(range(100, 120))  # 5 full blocks of 4
        h = paged.PrefixCache.block_hashes(p, 4)
        assert h == jpaged.PrefixCache.block_hashes(p, 4)
        assert len(h) == 5
        for i in range(5):
            assert h[i] == paged.PrefixCache.block_hashes(p[: 4 * (i + 1)], 4)[-1]
        # flip one token in block 0: EVERY downstream digest changes
        h2 = paged.PrefixCache.block_hashes([999] + p[1:], 4)
        assert all(x != y for x, y in zip(h, h2))
        assert paged.PrefixCache.block_hashes(p[:3], 4) == []  # sub-block prompt

    def test_match_longest_and_full_hit(self):
        def case(m):
            a = m.BlockAllocator(33, 4)
            pc = m.PrefixCache(a)
            p1 = list(range(100, 114))  # 14 tokens: 3 full blocks + tail of 2
            a.alloc(0, 4)
            e = pc.insert(p1, a.tables[0], stat_points={14: []}, logits=np.zeros(8))
            assert e is not None and [a.refcount(b) for b in e.blocks] == [2] * 4
            got = pc.match(p1[:12] + [7, 7, 7, 7])  # diverges after block 3
            assert got is not None and got[1] == 3
            assert not pc.is_full_hit(got[0], p1[:12] + [7, 7, 7, 7], 3)
            got = pc.match(p1)
            assert got[1] == 3 and pc.is_full_hit(got[0], p1, 3)
            assert pc.match([7] * 14) is None
            return a
        _same(case)

    def test_insert_first_wins_without_ref_leak(self):
        def case(m):
            a = m.BlockAllocator(33, 4)
            pc = m.PrefixCache(a)
            p = list(range(12))
            a.alloc(0, 3)
            assert pc.insert(p, a.tables[0]) is not None
            a.alloc(1, 3)
            # every boundary already indexed: refused before taking refs
            assert pc.insert(p, a.tables[1]) is None
            assert [a.refcount(b) for b in a.tables[1]] == [1, 1, 1]
            assert pc.stats()["entries"] == 1
            return a
        _same(case)

    def test_max_blocks_cap_evicts_lru(self):
        def case(m):
            a = m.BlockAllocator(33, 4)
            pc = m.PrefixCache(a, max_blocks=4)
            a.alloc(0, 3)
            pc.insert(list(range(12)), a.tables[0])
            a.alloc(1, 3)
            pc.insert(list(range(50, 62)), a.tables[1])
            st = pc.stats()
            assert st["evictions"] == 1 and st["blocks"] <= 4
            _check_invariant(a)
            return a
        _same(case)


# ==========================================================================
# Landmark-sum re-segmentation
# ==========================================================================
class TestResegmentSums:
    def test_fine_to_coarse_matches_direct_sums(self):
        rng = np.random.default_rng(60)
        sums = rng.normal(size=(1, 2, 8, 4)).astype(np.float32)
        out = resegment_sums(torch.from_numpy(sums), 2, 4).numpy()
        ref = np.zeros_like(out)
        ref[..., :4, :] = sums.reshape(1, 2, 4, 2, 4).sum(3)
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(out, np.asarray(jresegment_sums(jnp.asarray(sums), 2, 4)),
                                   atol=1e-6, rtol=1e-6)

    def test_token_level_oracle(self):
        """Re-segmenting per-segment token sums == summing the tokens under
        the coarse segmentation directly."""
        rng = np.random.default_rng(61)
        c, d, seg_f, seg_c = 8, 4, 2, 8
        toks = rng.normal(size=(c * seg_f, d)).astype(np.float32)
        fine = np.stack([toks[j * seg_f:(j + 1) * seg_f].sum(0) for j in range(c)])
        coarse = np.zeros((c, d), np.float32)
        for j in range(-(-c * seg_f // seg_c)):
            coarse[j] = toks[j * seg_c:(j + 1) * seg_c].sum(0)
        got = resegment_sums(torch.from_numpy(fine)[None, None], seg_f, seg_c)[0, 0]
        np.testing.assert_allclose(got.numpy(), coarse, atol=1e-5, rtol=1e-5)

    def test_identity_and_divisibility(self):
        sums = torch.ones((1, 1, 4, 2))
        assert resegment_sums(sums, 4, 4) is sums
        with pytest.raises(ValueError):
            resegment_sums(sums, 3, 4)


# ==========================================================================
# Engine: attach paths against the JAX engine and cold prefill
# ==========================================================================
class TestEnginePrefixCache:
    def test_full_hit_aligned_token_identical(self, weights):
        """Block-aligned full hit: the warm request skips prefill (its
        first token from the cached logits)."""
        p = _prompt(weights[0].vocab_size, 40, seed=50)  # 5 full blocks
        st, _, out = _both(weights, PREFIX, [p, p])
        assert out == _cold(weights, COLD, [p, p]) and out[0] == out[1]
        assert st["prefix"]["hits"] == 1 and st["prefix"]["misses"] == 1
        assert st["cow_copies"] == 0

    def test_full_hit_unaligned_cow_divergence(self, weights):
        """Unaligned full hit shares the partial last block: owner and warm
        request each copy it before their first divergent decode write."""
        p = _prompt(weights[0].vocab_size, 37, seed=51)
        st, _, out = _both(weights, PREFIX, [p, p])
        assert out == _cold(weights, COLD, [p, p])
        assert st["prefix"]["hits"] == 1 and st["cow_copies"] > 0

    def test_partial_hit_resumes_chunked_prefill(self, weights):
        """Shared 40-token prefix, distinct tails: the warm request attaches
        the shared blocks and the deepest stat point, then prefills its
        tail only."""
        vocab = weights[0].vocab_size
        shared = _prompt(vocab, 40, seed=52)
        prompts = [shared + _prompt(vocab, 13, seed=53), shared + _prompt(vocab, 13, seed=54)]
        st, _, out = _both(weights, PREFIX, prompts)
        assert out == _cold(weights, COLD, prompts)
        assert st["prefix"]["hits"] == 1
        assert st["prefix"]["entries"] == 2  # deeper prompt re-cached too

    def test_dense_engine_ignores_prefix_flag(self, weights):
        """No paged leaves: the flag is inert and no prefix stats show."""
        p = _prompt(weights[0].vocab_size, 24, seed=55)
        st, _, out = _both(weights, dict(PREFIX, paged=False, chunked_prefill=True), [p, p])
        assert out == _cold(weights, dict(COLD, paged=False), [p, p])
        assert "prefix" not in st

    def test_recompute_attach_warm_equals_cold(self, weights):
        """``prefix_attach="recompute"`` re-derives every stats row from the
        shared blocks (exact streaming; the ``reseg`` attach is the default
        of the cases above)."""
        p = _prompt(weights[0].vocab_size, 37, seed=56)
        serve = dict(PREFIX, prefix_attach="recompute")
        st, _, out = _both(weights, serve, [p, p])
        assert out == _cold(weights, COLD, [p, p])
        assert st["prefix"]["hits"] == 1

    def test_preempt_requeue_prefix_stays_cached(self, weights):
        """Pool pressure preempts a lane mid-decode; the shared entry is
        held by the other lanes' tables, so the requeued request re-attaches
        it; all outputs match the dense token-replay engine's."""
        jcfg, jparams, cfg, params = weights
        p = _prompt(cfg.vocab_size, 20, seed=57)
        serve = dict(PREFIX, max_lanes=3, num_blocks=12)
        outs, streams, stats = [], [], []
        for eng in (ServeEngine(cfg, params, serve=base.ServeConfig(**serve), device="cpu"),
                    JServeEngine(jcfg, jparams, serve=jbase.ServeConfig(**serve))):
            req = Request if isinstance(eng, ServeEngine) else JRequest
            stream = []
            for u in range(4):
                eng.submit(req(u, list(p), max_new_tokens=30,
                               on_token=lambda u, t, s=stream: s.append((u, t))))
            outs.append(dict(eng.run()))
            streams.append(stream)
            stats.append(eng.stats())
        assert outs[0] == outs[1] and streams[0] == streams[1]
        st, jst = stats
        assert st["preemptions"] == jst["preemptions"] > 0
        assert st["finished"] == 4
        assert st["prefix"]["hits"] == jst["prefix"]["hits"] >= 1
        dense = ServeEngine(cfg, params, serve=base.ServeConfig(
            **dict(BASE, paged=False, batched_prefill=False, max_lanes=3)), device="cpu")
        for u in range(4):
            dense.submit(Request(u, list(p), max_new_tokens=30))
        assert outs[0] == dense.run()

    @pytest.mark.parametrize("side", ["port", "jax"])
    def test_warm_flag_never_detaches_itl_chain(self, side):
        """``mark_prefix_hit``'s one-shot warm flag: the warm first token
        counts as TTFT and warm TTFT, a resume token after a requeue only
        as resume TTFT, never as ITL; the reference's histograms count the
        same."""
        m, sched_cls, req_cls = ((paged, Scheduler, Request) if side == "port"
                                 else (jpaged, JScheduler, JRequest))
        sched = sched_cls(m.BlockAllocator(17, 8), max_lanes=1, blocks_per_lane=8)
        req = req_cls(0, list(range(10)), max_new_tokens=4)
        sched.requeue_cb = lambda lane: req

        def read():  # both schedulers keep the reference's histograms
            return (sched._ttft_s.count, sched._warm_ttft_s.count, sched._itl_s.count,
                    sched._resume_ttft_s.count)

        counts = []
        sched.submit(req)
        assert sched.admit()
        sched.mark_prefix_hit(0)
        sched.note_token(0)  # warm first token
        assert 0 not in sched._warm_uids  # one-shot
        counts.append(read())
        sched.note_token(0)
        counts.append(read())
        sched.preempt(0)
        assert sched.admit()
        sched.note_token(0)  # resume token: resume TTFT only
        counts.append(read())
        sched.note_token(0)
        counts.append(read())
        assert counts == [(1, 1, 0, 0), (1, 1, 1, 0), (1, 1, 1, 1), (1, 1, 2, 1)]
