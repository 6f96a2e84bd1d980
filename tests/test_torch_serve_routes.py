"""The port's serving routes against the JAX reference, on the CPU.

Greedy tokens of ``repro_torch``'s ``ServeEngine(device="cpu")`` must be
identical to the reference ``ServeEngine`` on reduced Qwen2-7B for every
route the port serves: the reference's default ``ServeConfig()`` (replay
prefill, gather decode), the dense seed engine (``paged=False,
batched_prefill=False``), the mixed routes, ``decode_streaming=
"recompute"`` (which falls back to the gather route), exact decode
attention (``decode_attention_impl="full"``) on both decode routes, and a
pool small enough to preempt. ``stats()`` reports the same route and
preemptions as the reference's. Then K5's new shapes end to end: 48 query
heads on one kv head (r = 48) with 64-key blocks on the paged route.
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
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

# <= c (c = 16), > c inside a 32 bucket, > c across buckets, > c unpadded
PROMPT_LENS = (10, 29, 45, 32)
BASE = dict(max_lanes=3, max_seq=96, block_size=8)
# route: (ServeConfig fields, ModelConfig fields, the decode route stats()
# must report)
ROUTES = {
    "default": ({}, {}, "gather"),
    "dense_token_replay": (dict(paged=False, batched_prefill=False), {}, "gather"),
    "ss_fused_gather": (dict(prefill_impl="ss_fused"), {}, "gather"),
    "replay_paged": (dict(decode_impl="paged"), {}, "paged"),
    "recompute_asks_paged": (dict(decode_impl="paged"),
                             dict(decode_streaming="recompute"), "gather"),
    "full_gather": ({}, dict(decode_attention_impl="full"), "gather"),
    "full_paged": (dict(decode_impl="paged"), dict(decode_attention_impl="full"),
                   "paged"),
    "preempting_gather": (dict(num_blocks=12), {}, "gather"),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = jbase.reduced(jget_config("qwen2-7b"))
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _prompts(vocab: int, lens=PROMPT_LENS, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(3, vocab, size=n).tolist()) for uid, n in enumerate(lens)]


def _run_both(jcfg, jparams, cfg, params, serve_kw, prompts, max_new=10):
    """Both engines on the same requests; each request also streams its
    tokens through ``on_token``. Returns ((outputs, streamed, engine) for
    the reference, then for the port)."""
    out = []
    for eng, req in ((JServeEngine(jcfg, jparams, serve=jbase.ServeConfig(**serve_kw)),
                      JRequest),
                     (ServeEngine(cfg, params, serve=base.ServeConfig(**serve_kw),
                                  device="cpu"), Request)):
        streamed = []
        for uid, prompt in prompts:
            eng.submit(req(uid, list(prompt), max_new_tokens=max_new,
                           on_token=lambda u, t, s=streamed: s.append((u, t))))
        out.append((eng.run(), streamed, eng))
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_greedy_tokens_identical_to_jax_engine_by_route(weights, route):
    jcfg, jparams, params = weights
    serve_kw, model_kw, decode_impl = ROUTES[route]
    (jout, jstream, jeng), (out, stream, eng) = _run_both(
        dataclasses.replace(jcfg, **model_kw), jparams,
        dataclasses.replace(base.reduced(get_config("qwen2-7b")), **model_kw), params,
        dict(BASE, **serve_kw), _prompts(jcfg.vocab_size))
    assert sorted(out) == list(range(len(PROMPT_LENS)))
    assert out == jout
    assert stream == jstream          # on_token: the same calls in the same order
    stats, jstats = eng.stats(), jeng.stats()
    assert stats["decode_impl"] == jstats["decode_impl"] == decode_impl
    assert stats["mode"] == jstats["mode"]
    assert stats["decode_streaming"] == jstats["decode_streaming"]
    assert stats["preemptions"] == jeng.sched.total_preemptions
    assert (stats["preemptions"] > 0) == ("num_blocks" in serve_kw)


# --------------------------------------------------------------------------
# TestPagedDecodeImpl of tests/test_paged_serve.py, replayed on the port
# --------------------------------------------------------------------------
REF_BASE = dict(max_lanes=2, max_seq=64, block_size=8)


def _ref_requests(vocab: int, n: int, seed: int, lo=4, hi=24, max_new=8):
    """``tests/test_paged_serve.py:_requests``."""
    rng = np.random.default_rng(seed)
    return [(u, rng.integers(3, vocab, int(rng.integers(lo, hi))).tolist(), max_new)
            for u in range(n)]


def _port_run(cfg, params, reqs, serve_kw):
    eng = ServeEngine(cfg, params, serve=base.ServeConfig(**serve_kw), device="cpu")
    for uid, prompt, max_new in reqs:
        eng.submit(Request(uid, list(prompt), max_new_tokens=max_new))
    return eng.run(), eng


@pytest.mark.parametrize("case", ["test_full_attention_impl",
                                  "test_recompute_falls_back_to_gather"])
def test_paged_decode_impl_cases_replayed(weights, case):
    """The port's gather and paged routes against each other, as the
    reference test does, and both against the reference's paged run."""
    jcfg, jparams, params = weights
    field, value, seed, impl = {
        "test_full_attention_impl": ("decode_attention_impl", "full", 33, "paged"),
        "test_recompute_falls_back_to_gather": ("decode_streaming", "recompute", 32,
                                                "gather"),
    }[case]
    jcfg = dataclasses.replace(jcfg, capacity_factor=100.0, **{field: value})
    cfg = dataclasses.replace(base.reduced(get_config("qwen2-7b")),
                              capacity_factor=100.0, **{field: value})
    reqs = _ref_requests(cfg.vocab_size, 3, seed)
    ref, _ = _port_run(cfg, params, reqs, REF_BASE)
    out, eng = _port_run(cfg, params, reqs, dict(REF_BASE, decode_impl="paged"))
    assert eng.stats()["decode_impl"] == impl
    assert ref == out
    jeng = JServeEngine(jcfg, jparams, serve=jbase.ServeConfig(**REF_BASE,
                                                               decode_impl="paged"))
    for uid, prompt, max_new in reqs:
        jeng.submit(JRequest(uid, list(prompt), max_new_tokens=max_new))
    assert jeng.run() == out


# --------------------------------------------------------------------------
# K5 past 8 rows per kv head and past 32-key blocks, end to end
# --------------------------------------------------------------------------
def test_r48_block64_paged_route_identical_to_jax_engine():
    """48 query heads on 1 kv head (r = 48 rows per K5 launch, as in
    granite-20b) at head_dim 16, 64-key blocks, ss_fused prefill and paged
    decode: the tokens of the JAX engine (its Pallas kernel interpreted)."""
    kw = dict(num_heads=48, num_kv_heads=1, head_dim=16)
    jcfg = jbase.reduced(jget_config("granite-20b"), **kw)
    cfg = base.reduced(get_config("granite-20b"), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.num_heads // cfg.num_kv_heads == 48
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    serve_kw = dict(max_lanes=3, max_seq=256, block_size=64, prefill_impl="ss_fused",
                    decode_impl="paged")
    (jout, jstream, _), (out, stream, eng) = _run_both(
        jcfg, jparams, cfg, params, serve_kw,
        _prompts(cfg.vocab_size, lens=(10, 63, 64, 130)), max_new=12)
    assert eng.stats()["decode_impl"] == "paged"
    assert sorted(out) == [0, 1, 2, 3]
    assert out == jout and stream == jstream
