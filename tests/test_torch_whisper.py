"""Whisper-base (family ``audio``) on the port against the JAX reference,
on the CPU.

Reduced Whisper-base (d_model 128, 4 heads of 32, c = 16, 2 encoder and 2
decoder layers unless a test cuts them), fp32, weights from
``repro.models.params.init_params`` through ``params_from_numpy``, inputs
from numpy seeds, stub frames of 48 positions (the cells run 1500):

* ``layer_norm`` (population variance), ``sinusoidal_positions`` (48 and
  1500 rows), the gelu MLP (``jax.nn.gelu``'s tanh form) and
  ``cross_attention_forward`` with n_q = n_k and n_q != n_k (the
  rectangular branch: each sequence's own landmarks, no + delta V) under
  ``spectral_shift``, ``nystrom``, ``chunked`` and ``full``, at 1e-5 of
  max-abs;
* the parameter and cache trees equal the reference's; the engine's
  storage stacks the per-layer caches under the leaf names and keeps
  ``cross_k`` / ``cross_v`` lane-dense;
* ``model_forward`` logits and ``loss_fn`` under each encoder impl
  (``spectral_shift``, ``spectral_shift_fused``: the port's plain K1-K4
  on the CPU, the reference's dispatch's CPU route; ``chunked``) at 1
  encoder + 1 decoder layer (5e-4 of max-abs) and 2 + 2 (2e-2). Measured
  1.1e-4 and 3.7e-3: the random-weight decoder's cross attention is
  sharp (scores of std 30) and its residual stream starts at std 0.03
  under a LayerNorm, so fp32 rounding of the layers' inputs grows ~400x
  (ROADMAP P1); on the same inputs an encoder layer agrees to 1e-5
  (measured 4.4e-6), a decoder layer to 1e-4 (3.4e-5: its cross attention
  sees the self-attention's rounding through the sharp softmax);
* the decode step (``_whisper_decode``) of two lanes at positions 13 and
  37 with random K/V, landmark sums, streaming stats and nonzero cross
  K/V, on the gather route (exact, frozen) and the paged route (exact:
  K5's plain version), against ``jax.jit`` of the reference's
  ``decode_step`` per lane: logits and every returned leaf at 5e-5 at 1
  layer, 5e-4 at 2 (measured 6.6e-5, P1);
* greedy tokens, every ``on_token`` call and ``stats()["mode"]`` of
  ``ServeEngine(device="cpu")`` identical to the JAX engine's on the
  default route, ``ss_fused`` + ``paged``, ``paged=False`` and frozen
  streaming (and its rebases), all ``paged+replay-prefill`` (``dense+``
  for ``paged=False``); chunked prefill and the prefix cache inert; one
  chaos plan (outcomes, injections, preemptions);
* the loss, grad norm and every gradient of one step and the parameters'
  change over 3 steps against ``jax.jit(make_train_step)`` under
  ``spectral_shift`` and ``spectral_shift_fused`` encoders, 1 + 1 layers,
  seq 96, batch 2, at ``tests/test_torch_train.py``'s two-layer bounds:
  one Whisper layer pair is as ill-conditioned as two dense layers
  (measured grads 8.9e-5 of max-abs, the embedding's change 0.49 max-abs
  and 7.2e-3 L2: AdamW flips near-zero gradients, ROADMAP P3). At 2 + 2
  layers each package's gradients sit 1e-2 from a float64 run (measured
  port 3.4e-2, reference 1.4e-2 under spectral_shift; 5.6e-3 and 3.5e-3
  under chunked), so no bound would tell a fault from rounding there;
  the ``Trainer`` with ``data=`` and the launcher.

The family-generic parity helpers (``jax_train_run``,
``check_train_parity``, ``serve_both``) live here and serve
``tests/test_torch_vlm.py`` and ``tests/test_torch_xlstm.py`` too.
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
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro.serve import chaos as jchaos  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro.serve import workload as jworkload  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.kv_cache import cache_specs as jcache_specs  # noqa: E402
from repro.train import train_step as jtrain_step  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.pipeline import StubFrontendLM, to_device  # noqa: E402
from repro_torch.models import attention, layers, model  # noqa: E402
from repro_torch.models.params import (PATH_SEP, flatten_with_paths,  # noqa: E402
                                       map_specs, params_from_numpy, tree_leaves)
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.serve import chaos, decode, workload  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_cache import cache_specs  # noqa: E402
from repro_torch.serve.paged import PagedKVCache  # noqa: E402
from repro_torch.train.train_step import make_grad_step, make_train_step  # noqa: E402

ARCH = "whisper-base"
ENC = 48                     # stub frames in the tests (the cells: 1500)
SEQ, BATCH, STEPS = 96, 2, 3
TCFG = dict(warmup_steps=2, total_steps=10)
# tests/test_torch_train.py's bounds: (loss rel, grad-norm rel, grads of
# max-abs) and the parameters' change over the steps (max-abs gap, L2 gap)
TOL = {1: (1e-5, 1e-4, 1e-4), 2: (1e-4, 1e-2, 3e-3)}
CHANGE_TOL = {1: (5e-2, 2e-3), 2: (0.75, 0.1)}
PIECE_TOL = 1e-5
DEC_LAYER_TOL = 1e-4
LOGIT_TOL = {1: 5e-4, 2: 2e-2}
DECODE_TOL = {1: 5e-5, 2: 5e-4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cfgs(arch: str, layers: int = 2, **kw):
    """The reduced config of ``arch`` in both packages; Whisper's encoder
    gets as many layers as its decoder."""
    kw = dict(num_layers=layers, **kw)
    if arch == ARCH:
        kw.setdefault("encoder_layers", layers)
    return (jbase.reduced(jget_config(arch), **kw),
            base.reduced(get_config(arch), **kw))


def rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def both_params(jcfg):
    jparams = jinit_params(jmodel.model_specs(jcfg), jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def data_for(cfg, seq: int = SEQ, batch: int = BATCH, enc_len: int = ENC):
    return StubFrontendLM(cfg.family, cfg.vocab_size, seq, batch, d_model=cfg.d_model,
                          num_patches=cfg.num_patches, enc_len=enc_len, seed=0)


def jax_batch(host: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in host.items()}


def tree_shapes_match(cfg, jparams, seq_len: int = 64) -> None:
    """The port's parameter and cache spec trees equal the reference's
    (paths and shapes)."""
    shapes = {}
    map_specs(lambda path, s: shapes.__setitem__(path, tuple(s.shape)),
              model.model_specs(cfg))
    jshapes = {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
               tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert shapes == jshapes
    cshapes = {}
    map_specs(lambda path, s: cshapes.__setitem__(path, tuple(s.shape)),
              cache_specs(cfg, 2, seq_len))
    jc = jax.tree_util.tree_flatten_with_path(
        jcache_specs(jcfg_of(cfg), 2, seq_len), is_leaf=lambda t: hasattr(t, "axes"))[0]
    assert cshapes == {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                      for k in path): tuple(s.shape) for path, s in jc}


def jcfg_of(cfg):
    """The reference's ModelConfig with the port's field values."""
    return jbase.ModelConfig(**dataclasses.asdict(cfg))


# --------------------------------------------------------------------------
# training parity (batch-aware: frames / patches ride beside the tokens)
# --------------------------------------------------------------------------
def jax_train_run(jcfg, data) -> dict:
    """The reference's grad step at the initial weights and ``STEPS``
    train steps, ``jax.jit``-compiled, on ``data``'s batches."""
    jt = jbase.TrainConfig(**TCFG)
    lr_fn = jschedules.warmup_cosine(jt.learning_rate, jt.warmup_steps, jt.total_steps)
    params0 = jinit_params(jmodel.model_specs(jcfg), jax.random.PRNGKey(0))
    jloss0, jgrads0 = jax.jit(jtrain_step.make_grad_step(jcfg))(
        params0, jax_batch(data.batch(0)))
    step = jax.jit(jtrain_step.make_train_step(jcfg, jt, lr_fn))
    p, o, hist = params0, jadamw.adamw_init(params0), []
    for i in range(STEPS):
        p, o, m = step(p, o, jax_batch(data.batch(i)))
        hist.append({k: float(v) for k, v in m.items()})
    return dict(params0=params0, hist=hist, final=jax.tree.map(np.asarray, p),
                loss0=float(jloss0), grads0=jax.tree.map(np.asarray, jgrads0))


def _leaf(tree, path: str):
    for key in path.split(PATH_SEP):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def check_train_parity(cfg, ref: dict, bounds: int, data, change_tol=None) -> None:
    """The port's grad step and ``STEPS`` train steps against ``ref``
    (``jax_train_run``) on the same batches, at ``TOL[bounds]`` and the
    parameters' change at ``change_tol`` (default ``CHANGE_TOL[bounds]``)."""
    loss_tol, gn_tol, g_tol = TOL[bounds]
    params = params_from_numpy(jax.tree.map(np.asarray, ref["params0"]))
    loss, grads = make_grad_step(cfg)(params, to_device(data.batch(0), "cpu"))
    assert float(loss) == pytest.approx(ref["loss0"], rel=loss_tol)
    jgrads = jax.tree.leaves(ref["grads0"])
    assert len(tree_leaves(grads)) == len(jgrads)
    for (path, port), jg in zip(flatten_with_paths(grads).items(), jgrads):
        assert rel(port, jg) <= g_tol, path
    tcfg = base.TrainConfig(**TCFG)
    step = make_train_step(cfg, tcfg, schedules.warmup_cosine(
        tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps))
    opt = adamw.adamw_init(params)
    for i, h in enumerate(ref["hist"]):
        params, opt, m = step(params, opt, to_device(data.batch(i), "cpu"))
        if i == 0:
            assert abs(float(m["loss"]) - h["loss"]) <= loss_tol * abs(h["loss"])
            assert abs(float(m["grad_norm"]) - h["grad_norm"]) <= gn_tol * h["grad_norm"]
    max_tol, l2_tol = change_tol or CHANGE_TOL[bounds]
    ref0 = jax.tree.map(np.asarray, ref["params0"])
    for path, port in flatten_with_paths(params).items():
        fin, r0 = _leaf(ref["final"], path), _leaf(ref0, path)
        gap, change = port.numpy() - fin, fin - r0
        assert np.abs(gap).max() <= max_tol * np.abs(change).max(), path
        assert np.linalg.norm(gap) <= l2_tol * np.linalg.norm(change), path


# --------------------------------------------------------------------------
# serving against the JAX engine
# --------------------------------------------------------------------------
BASE = dict(max_lanes=2, max_seq=64, block_size=8)
ROUTES = {
    "default": ({}, {}),
    "ss_fused_paged": (dict(prefill_impl="ss_fused", decode_impl="paged"), {}),
    "dense": (dict(paged=False, batched_prefill=False), {}),
    "frozen": (dict(prefill_impl="ss_fused", decode_impl="paged"),
               dict(decode_streaming="frozen")),
}


def prompts_for(vocab: int, n: int = 2, seed: int = 37, lo: int = 4, hi: int = 10):
    """``test_paged_serve.py``'s ``_requests(cfg, n, seed, lo, hi)`` prompts."""
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, int(rng.integers(lo, hi))).tolist() for _ in range(n)]


def serve_once(engine_cls, request_cls, cfg, params, serve, prompts, max_new=4, **kw):
    eng = engine_cls(cfg, params, serve=serve, **kw)
    calls = []
    for uid, prompt in enumerate(prompts):
        eng.submit(request_cls(uid, list(prompt), max_new_tokens=max_new,
                               on_token=lambda u, t: calls.append((u, int(t)))))
    while not eng.sched.idle:
        eng.tick()
    return eng.finished, calls, eng


def serve_both(jcfg, jparams, cfg, params, serve_kw, model_kw, prompts, max_new=4):
    """The same requests through the JAX engine and the port's; returns
    ((tokens, on_token calls, stats) of each)."""
    jout, jcalls, jeng = serve_once(JServeEngine, JRequest,
                                    dataclasses.replace(jcfg, **model_kw), jparams,
                                    jbase.ServeConfig(**BASE, **serve_kw), prompts, max_new)
    out, calls, eng = serve_once(ServeEngine, Request, dataclasses.replace(cfg, **model_kw),
                                 params, base.ServeConfig(**BASE, **serve_kw), prompts,
                                 max_new, device="cpu")
    return (jout, jcalls, jeng.stats()), (out, calls, eng.stats())


ALLOC_PLAN = (("alloc_fail", dict(rate=0.15)), ("fragment", dict(rate=0.5)))


def chaos_both(jcfg, jparams, cfg, params, rules=ALLOC_PLAN, prompt_lens=(5, 9)) -> list:
    """One plan of the chaos soak (by default ``alloc_fail`` 0.15,
    ``fragment`` 0.5) on a seeded Poisson trace with the watchdog armed, in
    both engines: [(tokens, outcomes, injections, preemptions)] of each."""
    runs = []
    for m, wl, eng_cls, bmod, extra, p, c in (
            (jchaos, jworkload, JServeEngine, jbase, {}, jparams, jcfg),
            (chaos, workload, ServeEngine, base, {"device": "cpu"}, params, cfg)):
        trace = wl.poisson_trace(seed=0, n_requests=4, mean_interarrival_ticks=2,
                                 prompt_lens=prompt_lens, vocab_size=cfg.vocab_size,
                                 max_new_tokens=4)
        plan = m.FaultPlan(seed=0, rules=tuple(m.FaultRule(site, **kw)
                                               for site, kw in rules))
        eng = eng_cls(c, p, serve=bmod.ServeConfig(**BASE, watchdog_ticks=16),
                      chaos=plan, **extra)
        wl.replay_trace(eng, trace, max_ticks=800)
        assert eng.sched.idle
        st = eng.stats()
        runs.append((dict(eng.finished), dict(eng.outcomes), st["chaos_injections"],
                     st["preemptions"]))
    return runs


# ==========================================================================
# Layers
# ==========================================================================
@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = cfgs(ARCH)
    jparams, params = both_params(jcfg)
    return jcfg, jparams, cfg, params


def test_layer_norm_positions_and_gelu_mlp_match_jax(weights):
    jcfg, jparams, cfg, params = weights
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32) * 3 + 1
    sc, bi = (rng.standard_normal(cfg.d_model).astype(np.float32) for _ in range(2))
    assert rel(layers.layer_norm(torch.from_numpy(x), torch.from_numpy(sc),
                                 torch.from_numpy(bi), cfg.norm_eps),
               jlayers.layer_norm(x, sc, bi, jcfg.norm_eps)) <= PIECE_TOL
    for n in (ENC, 1500):
        assert rel(layers.sinusoidal_positions(n, 512),
                   jlayers.sinusoidal_positions(n, 512)) <= PIECE_TOL
    lp, jlp = params["layers"][0]["mlp"], jparams["layers"][0]["mlp"]
    assert set(lp) == {"w_up", "b_up", "w_down", "b_down"}
    assert rel(layers.mlp_forward(lp, torch.from_numpy(x), "gelu"),
               jlayers.mlp_forward(jlp, x, "gelu")) <= PIECE_TOL
    # the tanh form, not the erf form
    t = torch.linspace(-4, 4, 101)
    assert torch.equal(layers.gelu(t), torch.nn.functional.gelu(t, approximate="tanh"))


@pytest.mark.parametrize("impl", ["spectral_shift", "nystrom", "chunked", "full"])
@pytest.mark.parametrize("n_q", [40, ENC], ids=["rectangular", "square"])
def test_cross_attention_matches_jax(weights, impl, n_q):
    jcfg, jparams, cfg, params = weights
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, n_q, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, ENC, cfg.d_model)).astype(np.float32)
    p, jp = params["layers"][0]["cross_attn"], jparams["layers"][0]["cross_attn"]
    out = attention.cross_attention_forward(p, cfg, torch.from_numpy(x),
                                            torch.from_numpy(enc), impl=impl)
    ref = jattention.cross_attention_forward(jp, jcfg, x, enc, impl=impl)
    assert rel(out, ref) <= PIECE_TOL


def test_specs_cache_and_storage_layout(weights):
    jcfg, jparams, cfg, params = weights
    tree_shapes_match(cfg, jparams)
    kv = PagedKVCache(cfg, base.ServeConfig(**BASE), "cpu")
    assert kv.paged and kv.pool_names == ["k", "v"]
    assert set(kv.storage) == {"k", "v", "q_lmk", "k_lmk", "bv_m", "bv_l", "bv_acc",
                               "cross_k", "cross_v"}
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    assert tuple(kv.storage["cross_k"].shape) == (cfg.num_layers, 2, h, 1500, dh)
    assert tuple(kv.storage["k"].shape[:2]) == (cfg.num_layers, cfg.num_kv_heads)
    assert all(ids == (0, 1) for ids in kv.layer_ids.values())


# ==========================================================================
# Forward
# ==========================================================================
@pytest.mark.parametrize("impl", ["spectral_shift", "spectral_shift_fused", "chunked"])
@pytest.mark.parametrize("n_layers", [1, 2], ids=["1_layer", "2_layers"])
def test_model_forward_and_loss_match_jax(n_layers, impl):
    jcfg, cfg = cfgs(ARCH, n_layers, encoder_attention_impl=impl)
    jparams, params = both_params(jcfg)
    host = data_for(cfg, seq=40).batch(0)
    jlogits, _ = jax.jit(lambda p_, b_: jmodel.model_forward(p_, jcfg, b_))(
        jparams, jax_batch(host))
    logits, aux = model.model_forward(params, cfg, to_device(host, "cpu"))
    assert rel(logits, jlogits) <= LOGIT_TOL[n_layers]
    assert float(aux) == 0.0
    jloss, _ = jmodel.loss_fn(jparams, jcfg, jax_batch(host))
    loss, _ = model.loss_fn(params, cfg, to_device(host, "cpu"))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


def test_layers_on_the_same_inputs_match_jax(weights):
    """Each encoder layer on the same inputs at 1e-5, a decoder layer at
    1e-4 (the model's logit gap is the inputs' rounding, amplified)."""
    jcfg, jparams, cfg, params = weights
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, ENC, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    pos_e = np.broadcast_to(np.arange(ENC), (2, ENC)).copy()
    pos_d = np.broadcast_to(np.arange(40), (2, 40)).copy()
    for impl in ("spectral_shift", "chunked"):
        out = model.whisper_enc_layer_forward(params["enc_layers"][0], cfg,
                                              torch.from_numpy(enc), torch.from_numpy(pos_e),
                                              impl)
        ref = jmodel.whisper_enc_layer_forward(jparams["enc_layers"][0], jcfg, enc, pos_e,
                                               impl)
        assert rel(out, ref) <= PIECE_TOL
    out = model.whisper_dec_layer_forward(params["layers"][0], cfg, torch.from_numpy(x),
                                          torch.from_numpy(enc), torch.from_numpy(pos_d),
                                          "chunked", "spectral_shift")
    ref = jmodel.whisper_dec_layer_forward(jparams["layers"][0], jcfg, x, enc, pos_d,
                                           "chunked", "spectral_shift")
    assert rel(out, ref) <= DEC_LAYER_TOL


# ==========================================================================
# Decode step
# ==========================================================================
SEQ_MAX = 64
DECODE_CASES = {"gather_exact": ("gather", "exact"), "gather_frozen": ("gather", "frozen"),
                "paged_exact": ("paged", "exact")}


def _lane_caches(cfg, rng, pos, s_view):
    """Random per-lane decode state in the reference's B=1 layout: K/V rows
    0..pos-1, landmark sums and streaming stats on the rows reached, and
    nonzero cross K/V."""
    c, h, hkv, dh = (cfg.num_landmarks, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    seg = -(-SEQ_MAX // c)
    lanes = []
    for p_ in pos:
        rows = (np.arange(c) <= p_ // seg)[:, None]
        layers_ = []
        for _ in range(cfg.num_layers):
            k = np.zeros((1, hkv, s_view, dh), np.float32)
            v = np.zeros((1, hkv, s_view, dh), np.float32)
            k[:, :, :p_] = rng.standard_normal((1, hkv, p_, dh)) * 0.5
            v[:, :, :p_] = rng.standard_normal((1, hkv, p_, dh))
            layers_.append(dict(
                k=k, v=v,
                q_lmk=(rng.standard_normal((1, h, c, dh)) * rows).astype(np.float32),
                k_lmk=(rng.standard_normal((1, hkv, c, dh)) * rows).astype(np.float32),
                bv_m=(rng.standard_normal((1, h, c, 1)) * rows).astype(np.float32),
                bv_l=(rng.uniform(0.5, 2.0, (1, h, c, 1)) * rows).astype(np.float32),
                bv_acc=(rng.standard_normal((1, h, c, dh)) * rows).astype(np.float32)))
        cross = {n: rng.standard_normal((cfg.num_layers, 1, h, 1500, dh)).astype(np.float32)
                 for n in ("cross_k", "cross_v")}
        lanes.append(dict(layers=layers_, **cross))
    return lanes


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("n_layers", [1, 2], ids=["1_layer", "2_layers"])
def test_whisper_decode_matches_jax(n_layers, case):
    route, streaming = DECODE_CASES[case]
    jcfg, cfg = cfgs(ARCH, n_layers)
    jparams, params = both_params(jcfg)
    tol = DECODE_TOL[n_layers]
    jcfg = dataclasses.replace(jcfg, decode_streaming=streaming)
    cfg = dataclasses.replace(cfg, decode_streaming=streaming)
    rng = np.random.default_rng(5)
    pos, bs, s_view = np.array([13, 37], np.int32), 8, 40
    lanes = _lane_caches(cfg, rng, pos, s_view)
    tokens = rng.integers(3, cfg.vocab_size, (2, 1))
    names = ("k", "v", "q_lmk", "k_lmk", "bv_m", "bv_l", "bv_acc")
    # the port's storage layout: layers stacked first, lanes second
    layers_ = {n: torch.from_numpy(np.stack([np.concatenate(
        [ln["layers"][i][n] for ln in lanes]) for i in range(cfg.num_layers)]))
        for n in names}
    for n in ("cross_k", "cross_v"):
        layers_[n] = torch.from_numpy(np.concatenate([ln[n] for ln in lanes], axis=1))
    table = None
    if route == "paged":
        n_slots = s_view // bs
        table = np.arange(1, 2 * n_slots + 1, dtype=np.int32).reshape(2, n_slots)[:, ::-1].copy()
        for n in ("k", "v"):
            dense = layers_[n].numpy()                  # (L, B, Hkv, S, Dh)
            pool = np.zeros((cfg.num_layers, cfg.num_kv_heads, 2 * n_slots + 1, bs,
                             dense.shape[-1]), np.float32)
            for b in range(2):
                pool[:, :, table[b]] = dense[:, b].reshape(
                    cfg.num_layers, cfg.num_kv_heads, n_slots, bs, -1)
            layers_[n] = torch.from_numpy(pool)
    logits, new = decode.decode_step(
        params, cfg, {"pos": torch.from_numpy(pos), "layers": layers_},
        torch.from_numpy(tokens), seq_max=SEQ_MAX,
        paged_table=None if table is None else torch.from_numpy(table), block_size=bs)
    jstep = jax.jit(lambda c_, t_, tb: jdecode.decode_step(
        jparams, jcfg, c_, t_, seq_max=SEQ_MAX, paged_table=tb,
        paged_meta=None if tb is None else (bs, True)))
    for b in range(2):
        jcache = {"pos": jnp.asarray(pos[b]),
                  "layers": [{n: jnp.asarray(v) for n, v in lc.items()}
                             for lc in lanes[b]["layers"]],
                  "cross_k": jnp.asarray(lanes[b]["cross_k"]),
                  "cross_v": jnp.asarray(lanes[b]["cross_v"])}
        if route == "paged":
            for i, lc in enumerate(jcache["layers"]):
                for n in ("k", "v"):
                    lc[n] = jnp.asarray(layers_[n][i].numpy()[None])
        jlogits, jnew = jstep(jcache, jnp.asarray(tokens[b:b + 1]),
                              None if table is None else jnp.asarray(table[b]))
        assert rel(logits[b:b + 1], jlogits) <= tol
        for i in range(cfg.num_layers):
            for n in names:
                ref = np.asarray(jnew["layers"][i][n])
                if n in ("k", "v"):
                    ref = ref[:, :, pos[b]:pos[b] + 1] if route == "gather" else ref
                assert rel(new["layers"][i][n][b:b + 1], ref) <= tol, (i, n)
        assert int(jnew["pos"]) == int(new["pos"][b])


# ==========================================================================
# Serving against the JAX engine
# ==========================================================================
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_greedy_tokens_identical_to_jax_engine(weights, route):
    jcfg, jparams, cfg, params = weights
    serve_kw, model_kw = ROUTES[route]
    (jout, jcalls, jst), (out, calls, st) = serve_both(
        jcfg, jparams, cfg, params, serve_kw, model_kw, prompts_for(cfg.vocab_size))
    assert sorted(out) == [0, 1] and out == jout and calls == jcalls
    for key in ("mode", "decode_impl", "decode_streaming"):
        assert st[key] == jst[key]
    assert st["mode"] == ("dense" if route == "dense" else "paged") + "+replay-prefill"
    if route == "frozen":
        assert st["rebases"] == jst["rebases"] > 0


def test_chunked_and_prefix_settings_are_inert(weights):
    jcfg, jparams, cfg, params = weights
    kw = dict(chunked_prefill=True, prefix_cache=True, prefill_chunk_tokens=8,
              prefill_impl="ss_fused")
    (jout, _, jst), (out, _, st) = serve_both(jcfg, jparams, cfg, params, kw, {},
                                              prompts_for(cfg.vocab_size))
    assert out == jout
    for s in (st, jst):
        assert s["mode"] == "paged+replay-prefill" and "prefix" not in s


def test_chaos_plan_identical_to_jax_engine(weights):
    jcfg, jparams, cfg, params = weights
    runs = chaos_both(jcfg, jparams, cfg, params)
    assert runs[0] == runs[1]
    assert runs[1][2] > 0 and set(runs[1][1].values()) == {"finished"}


# ==========================================================================
# Training
# ==========================================================================
@pytest.mark.parametrize("impl", ["spectral_shift", "spectral_shift_fused"])
def test_train_steps_match_jax(impl):
    jcfg, cfg = cfgs(ARCH, 1, encoder_attention_impl=impl)
    data = data_for(cfg)
    check_train_parity(cfg, jax_train_run(jcfg, data), 2, data)


def test_trainer_with_data_and_launcher(tmp_path):
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import Trainer

    cfg = base.reduced(get_config(ARCH), encoder_attention_impl="spectral_shift_fused")
    data = data_for(cfg, seq=48)
    trainer = Trainer(cfg, base.TrainConfig(checkpoint_dir=str(tmp_path)),
                      base.ShapeConfig("t", 48, BATCH, "train"), device="cpu", data=data)
    hist = trainer.run(2)
    assert trainer.data is data and all(np.isfinite(h["loss"]) for h in hist)
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                              "2", "--batch", "1", "--seq", "48", "--encoder-attention",
                              "spectral_shift_fused"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    from repro_torch.launch import serve as launch_serve

    with pytest.raises(SystemExit, match="encoder features"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
