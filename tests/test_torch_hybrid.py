"""The hybrid family (Hymba: GQA attention and a mamba selective SSM in
parallel, then an MLP) on the port against the JAX reference, on the CPU.

Reduced Hymba-1.5B (d_model 128, 4 heads on 1 kv head of 32, c = 16, SSM
state 8, conv width 4), fp32, weights from ``repro.models.params.
init_params`` through ``params_from_numpy``, inputs from numpy seeds:

* ``_causal_conv`` and ``mamba_forward`` against the reference's, with
  and without an input state, at a length (40) that is not a multiple of
  ``ssm_chunk`` (16), at 1e-5 of max-abs (measured 2.4e-7: the in-chunk
  scan associates in another order than ``lax.associative_scan``);
  ``mamba_decode`` one step against the reference's, and fed token by
  token against ``mamba_forward`` over the sequence (outputs and final
  state, 1e-5);
* ``model_forward`` logits at 1 layer (5e-5 of max-abs) and at 2 layers
  (5e-4, ROADMAP P1; measured 5.0e-6 and 3.8e-5);
* training under ``spectral_shift_fused`` (the port's plain K1-K4 on the
  CPU, the reference's dispatch's CPU route), ``ssm_chunk`` 16 so the
  96-token sequences cross chunk carries, at 1 and 2 layers, under remat
  "none", "full" and "ss_stats" (measured: grads 1.8e-5 / 8.8e-5 of
  max-abs, the change 1.2e-2 / 0.49 max-abs and 1.9e-4 / 3.2e-2 L2 at 1 /
  2 layers, the same under each policy): the checks and bounds of
  ``tests/test_torch_moe_train.py``'s ``check_train_parity`` against
  ``jax.jit`` of the reference's ``make_grad_step`` / ``make_train_step``;
  the ``Trainer`` and the launcher on the CPU;
* greedy tokens and every ``on_token`` call of ``ServeEngine(device=
  "cpu")`` identical to the JAX engine's on the routes of
  ``tests/test_paged_serve.py::test_hybrid_family_paged_decode`` (its
  requests: seed 37, 4-9 tokens, 4 new): the default replay + gather
  route, ``prefill_impl="ss_fused"`` + ``decode_impl="paged"``,
  ``paged=False``, ``decode_streaming="frozen"`` (and its rebase count),
  and one chaos plan (``alloc_fail`` + ``fragment`` on a Poisson trace,
  with its outcomes and injections); defragmentation between ticks;
  ``chunked_prefill`` and ``prefix_cache`` inert, as ``stats()`` says in
  both engines (``paged+replay-prefill``, no prefix stats).
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
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.serve import chaos as jchaos  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro.serve import workload as jworkload  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.kv_cache import cache_specs as jcache_specs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import model, ssm  # noqa: E402
from repro_torch.models.params import map_specs, params_from_numpy  # noqa: E402
from repro_torch.serve import chaos, decode, prefill, workload  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import cache_leaf_layout, cache_specs  # noqa: E402
from test_torch_moe_train import _jax_run, check_train_parity  # noqa: E402

ARCH = "hymba-1.5b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(layers: int = 2, **kw):
    kw = dict(num_layers=layers, **kw)
    return jbase.reduced(jget_config(ARCH), **kw), base.reduced(get_config(ARCH), **kw)


def _rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _cfgs()
    jparams = jinit_params(jmodel.model_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams))


# ==========================================================================
# The selective SSM
# ==========================================================================
@pytest.fixture(scope="module")
def mamba():
    """Layer 0's mamba weights with a_log and b_dt drawn away from their
    zero init, and an input of 40 positions (chunks of 16: one padded)."""
    jcfg, cfg = _cfgs()
    jparams = jinit_params(jmodel.model_specs(jcfg), jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["mamba"])
    rng = np.random.default_rng(4)
    di, n = jp["a_log"].shape
    jp = dict(jp, a_log=jnp.asarray(rng.normal(size=(di, n)).astype(np.float32) * 0.5),
              b_dt=jnp.asarray(rng.normal(size=(di,)).astype(np.float32) * 0.5))
    p = params_from_numpy(jax.tree.map(np.asarray, jp))
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    state = (rng.normal(size=(2, di, n)).astype(np.float32),
             rng.normal(size=(2, cfg.conv_width - 1, di)).astype(np.float32))
    return jcfg, cfg, jp, p, x, state


def test_causal_conv_matches_jax(mamba):
    _, _, jp, p, x, _ = mamba
    ref = jssm._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"] + 0.3)
    out = ssm._causal_conv(torch.from_numpy(x), p["conv_w"], p["conv_b"] + 0.3)
    assert _rel(out, ref) <= 1e-5


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "input_state"])
def test_mamba_forward_matches_jax(mamba, with_state):
    jcfg, cfg, jp, p, x, state = mamba
    jst = tuple(map(jnp.asarray, state)) if with_state else None
    st = tuple(map(torch.from_numpy, state)) if with_state else None
    jout, (jh, jconv) = jax.jit(lambda p_, x_, st_: jssm.mamba_forward(
        p_, x_, cfg.ssm_state, chunk=16, state=st_))(jp, jnp.asarray(x), jst)
    out, (h, conv) = ssm.mamba_forward(p, torch.from_numpy(x), cfg.ssm_state, chunk=16,
                                       state=st)
    assert x.shape[1] % 16
    assert _rel(out, jout) <= 1e-5
    assert _rel(h, jh) <= 1e-5 and h.dtype == torch.float32
    assert _rel(conv, jconv) <= 1e-5


def test_mamba_decode_matches_jax_and_the_forward(mamba):
    jcfg, cfg, jp, p, x, state = mamba
    st = {"ssm_h": torch.from_numpy(state[0]), "conv": torch.from_numpy(state[1])}
    out, new = decode.mamba_decode(p, cfg, torch.from_numpy(x[:, :1]), st)
    jout, jnew = jdecode.mamba_decode(jp, jcfg, jnp.asarray(x[:, :1]),
                                      {"ssm_h": jnp.asarray(state[0]),
                                       "conv": jnp.asarray(state[1])})
    assert _rel(out, jout) <= 1e-5
    for k in new:
        assert _rel(new[k], jnew[k]) <= 1e-5
    # teacher-forced from zero state == the chunked forward over the sequence
    di = p["a_log"].shape[0]
    st = {"ssm_h": torch.zeros(2, di, cfg.ssm_state),
          "conv": torch.zeros(2, cfg.conv_width - 1, di)}
    steps = []
    for t in range(x.shape[1]):
        o, st = decode.mamba_decode(p, cfg, torch.from_numpy(x[:, t:t + 1]), st)
        steps.append(o)
    full, (h, conv) = ssm.mamba_forward(p, torch.from_numpy(x), cfg.ssm_state, chunk=16)
    assert _rel(torch.cat(steps, dim=1), full) <= 1e-5
    assert _rel(st["ssm_h"], h) <= 1e-5 and _rel(st["conv"], conv) <= 1e-5


# ==========================================================================
# Specs, cache layout, forward
# ==========================================================================
def test_specs_and_cache_layout_mirror_jax(weights):
    jcfg, jparams, cfg, params = weights
    shapes = {}
    map_specs(lambda path, s: shapes.__setitem__(path, tuple(s.shape)),
              model.model_specs(cfg))
    jshapes = {"/" + "/".join(str(k.key) for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert shapes == jshapes
    cshapes = {}
    map_specs(lambda path, s: cshapes.__setitem__(path, (tuple(s.shape), s.dtype)),
              cache_specs(cfg, 2, 64))
    jc = jax.tree_util.tree_flatten_with_path(
        jcache_specs(jcfg, 2, 64), is_leaf=lambda t: hasattr(t, "axes"))[0]
    jcshapes = {"/" + "/".join(str(k.key) for k in path): tuple(s.shape) for path, s in jc}
    assert {k: v[0] for k, v in cshapes.items()} == jcshapes
    assert cshapes["/layers/mamba/ssm_h"][1] == torch.float32
    seq = {path.rsplit("/", 1)[-1] for path, _, ax in cache_leaf_layout(cfg, 64)
           if ax is not None}
    assert seq == {"k", "v"}       # the mamba leaves stay lane-dense
    assert not prefill.prefill_supported(cfg)
    with pytest.raises(ValueError, match="unsupported for family hybrid"):
        prefill.batched_prefill(params, cfg, torch.zeros(1, 8, dtype=torch.long), 8,
                                seq_max=64, prefill_impl="replay")


@pytest.mark.parametrize("layers,tol", [(1, 5e-5), (2, 5e-4)], ids=["1_layer", "2_layers"])
def test_model_forward_logits_match_jax(weights, layers, tol):
    jcfg, jparams, cfg, params = weights
    first = lambda t: t[:layers]  # noqa: E731
    jcfg, cfg = (dataclasses.replace(c, num_layers=layers) for c in (jcfg, cfg))
    jp = dict(jparams, layers=jax.tree.map(first, jparams["layers"]))
    p = dict(params, layers=jax.tree.map(first, params["layers"]))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40))
    jlogits, _ = jax.jit(lambda p_, t_: jmodel.model_forward(p_, jcfg, {"tokens": t_}))(
        jp, jnp.asarray(tokens))
    logits, aux = model.model_forward(p, cfg, {"tokens": torch.from_numpy(tokens)})
    assert _rel(logits, jlogits) <= tol
    assert float(aux) == 0.0


# ==========================================================================
# Training
# ==========================================================================
# chunks of 16: the 96-token training sequences cross 5 chunk carries
TRAIN_KW = dict(attention_impl="spectral_shift_fused", ssm_chunk=16)


@pytest.fixture(scope="module", params=[1, 2], ids=["1_layer", "2_layers"])
def jax_train(request):
    jcfg, _ = _cfgs(request.param, **TRAIN_KW)
    return request.param, _jax_run(jcfg)


@pytest.mark.parametrize("remat", ["none", "full", "ss_stats"])
def test_train_steps_match_jax(jax_train, remat):
    layers, ref = jax_train
    _, cfg = _cfgs(layers, remat=remat, **TRAIN_KW)
    check_train_parity(cfg, ref, layers)


def test_trainer_and_launcher_train_hymba(tmp_path):
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import Trainer

    hist = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                              "2", "--batch", "2", "--seq", "48",
                              "--attention", "spectral_shift_fused"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    trainer = Trainer(base.reduced(get_config(ARCH)),
                      base.TrainConfig(checkpoint_dir=str(tmp_path)),
                      base.ShapeConfig("t", 48, 2, "train"), device="cpu")
    assert all(np.isfinite(m["loss"]) and m["aux"] == 0 for m in trainer.run(2))


# ==========================================================================
# Serving against the JAX engine
# ==========================================================================
BASE = dict(max_lanes=2, max_seq=64, block_size=8)
ROUTES = {
    "default": ({}, {}),
    "ss_fused_paged": (dict(prefill_impl="ss_fused", decode_impl="paged"), {}),
    "dense": (dict(paged=False, batched_prefill=False), {}),
    "frozen": (dict(prefill_impl="ss_fused", decode_impl="paged"),
               dict(decode_streaming="frozen")),
}


def _prompts(vocab):
    """``test_paged_serve.py``'s ``_requests(cfg, 2, seed=37, lo=4, hi=10)``."""
    rng = np.random.default_rng(37)
    return [rng.integers(3, vocab, int(rng.integers(4, 10))).tolist() for _ in range(2)]


def _serve(engine_cls, request_cls, cfg, params, serve, prompts, max_new=4,
           defrag=False, **kw):
    eng = engine_cls(cfg, params, serve=serve, **kw)
    calls = []
    for uid, prompt in enumerate(prompts):
        eng.submit(request_cls(uid, list(prompt), max_new_tokens=max_new,
                               on_token=lambda u, t: calls.append((u, int(t)))))
    moved = 0
    while not eng.sched.idle:
        eng.tick()
        if defrag:
            moved += eng.defragment()
    return eng.finished, calls, eng, moved


@pytest.fixture(scope="module")
def jax_default(weights):
    jcfg, jparams, cfg, _ = weights
    out, calls, eng, _ = _serve(JServeEngine, JRequest, jcfg, jparams,
                                jbase.ServeConfig(**BASE), _prompts(cfg.vocab_size))
    return out, calls, eng.stats()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_greedy_tokens_identical_to_jax_engine(weights, jax_default, route):
    jcfg, jparams, cfg, params = weights
    serve_kw, model_kw = ROUTES[route]
    prompts = _prompts(cfg.vocab_size)
    if route == "default":
        jout, jcalls, jstats = jax_default
    else:
        jout, jcalls, jeng, _ = _serve(JServeEngine, JRequest,
                                       dataclasses.replace(jcfg, **model_kw), jparams,
                                       jbase.ServeConfig(**BASE, **serve_kw), prompts)
        jstats = jeng.stats()
    out, calls, eng, _ = _serve(ServeEngine, Request, dataclasses.replace(cfg, **model_kw),
                                params, base.ServeConfig(**BASE, **serve_kw), prompts,
                                device="cpu")
    assert sorted(out) == [0, 1] and out == jout and calls == jcalls
    stats = eng.stats()
    for key in ("mode", "decode_impl", "decode_streaming"):
        assert stats[key] == jstats[key]
    assert stats["mode"].endswith("+replay-prefill")
    if route == "frozen":
        assert stats["rebases"] == jstats["rebases"] > 0


def test_chunked_and_prefix_settings_are_inert(weights, jax_default):
    """``chunked_prefill`` and ``prefix_cache`` are silently off for a
    family without batched prefill (``engine.py:180-197``): the same
    tokens, the replay route, no prefix stats, in both engines."""
    jcfg, jparams, cfg, params = weights
    kw = dict(BASE, chunked_prefill=True, prefix_cache=True, prefill_chunk_tokens=8,
              batched_prefill=True, prefill_impl="ss_fused")
    prompts = _prompts(cfg.vocab_size)
    jout, _, jeng, _ = _serve(JServeEngine, JRequest, jcfg, jparams,
                              jbase.ServeConfig(**kw), prompts)
    out, _, eng, _ = _serve(ServeEngine, Request, cfg, params, base.ServeConfig(**kw),
                            prompts, device="cpu")
    assert out == jout == jax_default[0]
    for st in (eng.stats(), jeng.stats()):
        assert st["mode"] == "paged+replay-prefill" and "prefix" not in st
    assert eng.prefix is None and eng.sched.chunk_tokens == 0


def test_defragment_between_ticks_keeps_tokens(weights, jax_default):
    """Block moves of the paged attention leaves beside the lane-dense
    mamba state (``apply_mapping``) leave the tokens unchanged; the chaos
    ``fragment`` site scatters the free list so moves happen."""
    _, _, cfg, params = weights
    plan = chaos.FaultPlan(seed=1, rules=(chaos.FaultRule("fragment", rate=1.0),))
    out, _, _, moved = _serve(ServeEngine, Request, cfg, params,
                              base.ServeConfig(**BASE, decode_impl="paged"),
                              _prompts(cfg.vocab_size), device="cpu", defrag=True,
                              chaos=plan)
    assert out == jax_default[0] and moved > 0


def test_chaos_plan_identical_to_jax_engine(weights):
    """One plan of ``tests/test_torch_chaos.py``'s soak (``alloc_fail`` at
    0.15, ``fragment`` at 0.5) on a seeded Poisson trace with the watchdog
    armed: tokens, outcomes, injections and preemptions equal the JAX
    engine's; every request finishes."""
    jcfg, jparams, cfg, params = weights
    runs = []
    for m, wl, eng_cls, bmod, extra, p, c in (
            (jchaos, jworkload, JServeEngine, jbase, {}, jparams, jcfg),
            (chaos, workload, ServeEngine, base, {"device": "cpu"}, params, cfg)):
        trace = wl.poisson_trace(seed=0, n_requests=4, mean_interarrival_ticks=2,
                                 prompt_lens=(5, 9), vocab_size=cfg.vocab_size,
                                 max_new_tokens=4)
        plan = m.FaultPlan(seed=0, rules=(m.FaultRule("alloc_fail", rate=0.15),
                                          m.FaultRule("fragment", rate=0.5)))
        eng = eng_cls(c, p, serve=bmod.ServeConfig(**BASE, watchdog_ticks=16),
                      chaos=plan, **extra)
        wl.replay_trace(eng, trace, max_ticks=800)
        assert eng.sched.idle
        st = eng.stats()
        runs.append((dict(eng.finished), dict(eng.outcomes), st["chaos_injections"],
                     st["preemptions"]))
    assert runs[0] == runs[1]
    assert runs[1][2] > 0 and set(runs[1][1].values()) == {"finished"}
