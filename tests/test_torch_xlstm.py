"""xLSTM-350M (family ``ssm``) on the port against the JAX reference, on
the CPU.

Reduced xLSTM-350M (d_model 128, 4 heads; mLSTM inner width 256, 64 a
head; sLSTM 32 a head) with ``slstm_every=2``, so block 1 is an sLSTM
block (``reduced()`` keeps the config's 6, which at 2 layers leaves none),
fp32, weights from ``repro.models.params.init_params`` through
``params_from_numpy``, inputs from numpy seeds:

* ``mlstm_chunked`` at s = 40 with chunks of 16 (the last one padded),
  fresh and from a carried state, outputs and the final (C, n, m);
  ``mlstm_step``; ``slstm_scan`` fresh and from a state; the block decode
  steps ``mlstm_block_decode`` / ``slstm_block_decode``: all at 1e-5 of
  max-abs;
* the parameter and cache trees equal the reference's; the engine's
  storage keys the blocks' leaves by their path below the layer index
  (``kind_mlstm/c``, ``kind_slstm/c``: both groups carry ``c``, ``n``,
  ``m``), lane-dense, no allocator;
* in bf16, 6 replayed tokens' logits (the fp32 cell output promotes the
  stack to fp32 after the first mLSTM block, in both packages) at 5e-2,
  under the 2.4-9.4% that bf16 itself moves them;
* ``model_forward`` logits at 1 and 2 layers (1e-5; measured 1.0e-6 and
  2.2e-6) and ``loss_fn``;
* greedy tokens, every ``on_token`` call and ``stats()`` of
  ``ServeEngine(device="cpu")`` identical to the JAX engine's on the
  default route, ``ss_fused`` + ``paged``, ``paged=False`` and with
  chunked prefill and the prefix cache asked for: every one
  ``dense+replay-prefill`` with no ``"kv"`` (the reference's
  ``test_ssm_family_falls_back_dense``), token replay from the zero state
  (m = 0, not the forward's -1e30); one chaos plan (``drop_sample``: a
  replay-preempt on the lane-dense state);
* at the configs' own chunk of 256 (seq 256) the reference's gradients
  are NaN (its in-chunk decay matrix takes exp before the mask and
  overflows: 0 * inf), the port's are finite and equal the reference's at
  chunks of 64, the same function, within 1e-4 of max-abs (measured
  2.4e-5): a named difference (ROADMAP);
* the loss, grad norm and every gradient of one step and the parameters'
  change over 3 steps against ``jax.jit(make_train_step)`` at 1 and 2
  layers (``ssm_chunk`` 16, so the 96-token sequences cross 5 chunk
  carries), at ``tests/test_torch_train.py``'s bounds; the ``Trainer``
  and the launcher.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve import decode as jdecode  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.models import model, ssm  # noqa: E402
from repro_torch.serve import decode  # noqa: E402
from repro_torch.serve.paged import PagedKVCache  # noqa: E402
from test_torch_whisper import (ROUTES, both_params, cfgs, chaos_both,  # noqa: E402
                                check_train_parity, data_for, jax_batch,
                                jax_train_run, prompts_for, rel, serve_both,
                                tree_shapes_match)

ARCH = "xlstm-350m"
KW = dict(slstm_every=2)
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = cfgs(ARCH, **KW)
    jparams, params = both_params(jcfg)
    return jcfg, jparams, cfg, params


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def mlstm_inputs():
    rng = np.random.default_rng(3)
    b, h, s, dh = 2, 4, 40, 16
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    ilog = rng.standard_normal((b, h, s)).astype(np.float32)
    flog = np.log(1 / (1 + np.exp(-rng.standard_normal((b, h, s)) - 2))).astype(np.float32)
    state = (rng.standard_normal((b, h, dh, dh)).astype(np.float32),
             rng.standard_normal((b, h, dh)).astype(np.float32),
             rng.standard_normal((b, h)).astype(np.float32))
    return q, k, v, ilog, flog, state


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "carried"])
def test_mlstm_chunked_matches_jax(mlstm_inputs, with_state):
    q, k, v, ilog, flog, state = mlstm_inputs
    st = state if with_state else None
    out, fin = ssm.mlstm_chunked(*_t(q, k, v, ilog, flog),
                                 state=None if st is None else tuple(_t(*st)), chunk=16)
    ref, jfin = jssm.mlstm_chunked(q, k, v, ilog, flog, state=st, chunk=16)
    assert out.shape == (2, 4, 40, 16)
    assert rel(out, ref) <= TOL
    for a, b in zip(fin, jfin):
        assert rel(a, b) <= TOL


def test_mlstm_step_matches_jax(mlstm_inputs):
    q, k, v, ilog, flog, state = mlstm_inputs
    args = [a[:, :, 7] for a in (q, k, v, ilog, flog)]
    out, new = ssm.mlstm_step(*_t(*args), tuple(_t(*state)))
    ref, jnew = jssm.mlstm_step(*args, state)
    assert rel(out, ref) <= TOL
    for a, b in zip(new, jnew):
        assert rel(a, b) <= TOL


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "carried"])
def test_slstm_scan_matches_jax(with_state):
    rng = np.random.default_rng(4)
    b, s, h, dh = 2, 24, 4, 8
    xg = rng.standard_normal((b, s, h, 4, dh)).astype(np.float32)
    r_w = (rng.standard_normal((h, 4, dh, dh)) * 0.3).astype(np.float32)
    st = None
    if with_state:
        st = (rng.standard_normal((b, h, dh)).astype(np.float32),
              rng.uniform(0.5, 2, (b, h, dh)).astype(np.float32),
              rng.standard_normal((b, h, dh)).astype(np.float32),
              rng.standard_normal((b, h, dh)).astype(np.float32))
    out, fin = ssm.slstm_scan(*_t(xg, r_w), state=None if st is None else tuple(_t(*st)))
    ref, jfin = jssm.slstm_scan(xg, r_w, state=st)
    assert rel(out, ref) <= TOL
    for a, b_ in zip(fin, jfin):
        assert rel(a, b_) <= TOL


def test_block_decode_steps_match_jax(weights):
    jcfg, jparams, cfg, params = weights
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    h, di = cfg.num_heads, 2 * cfg.d_model
    mstate = dict(c=rng.standard_normal((2, h, di // h, di // h)),
                  n=rng.standard_normal((2, h, di // h)), m=rng.standard_normal((2, h)),
                  conv=rng.standard_normal((2, cfg.conv_width - 1, di)))
    dh = cfg.d_model // h
    sstate = dict(c=rng.standard_normal((2, h, dh)), n=rng.uniform(0.5, 2, (2, h, dh)),
                  m=rng.standard_normal((2, h, dh)), h=rng.standard_normal((2, h, dh)))
    for fn, jfn, kind, st in ((decode.mlstm_block_decode, jdecode.mlstm_block_decode,
                               "kind_mlstm", mstate),
                              (decode.slstm_block_decode, jdecode.slstm_block_decode,
                               "kind_slstm", sstate)):
        st = {k: v.astype(np.float32) for k, v in st.items()}
        i = 0 if kind == "kind_mlstm" else 1
        out, new = fn(params["layers"][i][kind], cfg, torch.from_numpy(x),
                      {k: torch.from_numpy(v) for k, v in st.items()})
        ref, jnew = jfn(jparams["layers"][i][kind], jcfg, x, st)
        assert rel(out, ref) <= TOL
        assert set(new) == set(jnew)
        for k in new:
            assert rel(new[k], jnew[k]) <= TOL, (kind, k)


def test_bf16_decode_steps_match_jax(weights):
    """The compute dtype of the cells: in bf16 an mLSTM block's fp32 cell
    output promotes its product and the residual to fp32, so the stack
    runs fp32 after it, in both packages (the logits are fp32 in both); 6
    replayed tokens' logits within 5e-2 of max-abs: bf16 rounding alone
    moves either package's logits 2.4-9.4% from its fp32 run (measured
    port against reference 1.5-3.5%)."""
    jcfg, jparams, cfg, params = weights
    jcfg, cfg = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, cfg))
    from repro.serve.kv_cache import cache_specs as jcache_specs
    from repro_torch.configs.base import ServeConfig

    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype or jnp.float32),
                          jcache_specs(jcfg, 2, 64), is_leaf=lambda t: hasattr(t, "axes"))
    kv = PagedKVCache(cfg, ServeConfig(max_lanes=2, max_seq=64, block_size=8), "cpu")
    step = kv.make_fused_step(lambda c_, t_: decode.decode_step(params, cfg, c_, t_,
                                                               seq_max=64))
    jstep = jax.jit(lambda c_, t_: jdecode.decode_step(jparams, jcfg, c_, t_))
    tokens = np.random.default_rng(8).integers(1, cfg.vocab_size, (2, 6))
    for t in range(tokens.shape[1]):
        logits = step(torch.zeros((2, 1), dtype=torch.int32),
                      torch.from_numpy(tokens[:, t:t + 1]),
                      torch.full((2,), t, dtype=torch.int32), torch.ones(2, dtype=torch.bool), 1)
        jlogits, jcache = jstep(jcache, jnp.asarray(tokens[:, t:t + 1], jnp.int32))
        assert logits.dtype == torch.float32 and jlogits.dtype == jnp.float32
        assert rel(logits.float(), np.asarray(jlogits, np.float32)) <= 5e-2


def test_specs_cache_and_storage_layout(weights):
    jcfg, jparams, cfg, params = weights
    tree_shapes_match(cfg, jparams)
    assert [list(lp) for lp in params["layers"]] == [["kind_mlstm"], ["kind_slstm"]]
    kv = PagedKVCache(cfg, base.ServeConfig(max_lanes=2, max_seq=64, block_size=8), "cpu")
    assert not kv.paged and not kv.pool_names and not kv.seq_names
    assert set(kv.storage) == {f"kind_mlstm/{n}" for n in ("c", "n", "m", "conv")} | {
        f"kind_slstm/{n}" for n in ("c", "n", "m", "h")}
    assert kv.layer_ids["kind_mlstm/c"] == (0,) and kv.layer_ids["kind_slstm/c"] == (1,)
    assert tuple(kv.storage["kind_mlstm/c"].shape) == (1, 2, 4, 64, 64)
    assert tuple(kv.storage["kind_slstm/c"].shape) == (1, 2, 4, 32)
    # at the config's own slstm_every (6), 2 blocks are both mLSTM: leaf
    # names are unique, so storage keys them by the last name
    plain = PagedKVCache(base.reduced(registry.get_config(ARCH)),
                         base.ServeConfig(max_lanes=2, max_seq=64, block_size=8), "cpu")
    assert set(plain.storage) == {"c", "n", "m", "conv"}
    assert plain.layer_ids["c"] == (0, 1)


@pytest.mark.parametrize("n_layers", [1, 2], ids=["1_layer", "2_layers"])
def test_model_forward_and_loss_match_jax(n_layers):
    jcfg, cfg = cfgs(ARCH, n_layers, ssm_chunk=16, **KW)
    jparams, params = both_params(jcfg)
    host = data_for(cfg, seq=40).batch(0)
    jlogits, _ = jax.jit(lambda p_, b_: jmodel.model_forward(p_, jcfg, b_))(
        jparams, jax_batch(host))
    logits, aux = model.model_forward(params, cfg, to_device(host, "cpu"))
    assert rel(logits, jlogits) <= TOL
    jloss, _ = jmodel.loss_fn(jparams, jcfg, jax_batch(host))
    loss, _ = model.loss_fn(params, cfg, to_device(host, "cpu"))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


SERVE_ROUTES = dict(ROUTES, chunked_prefix=(dict(chunked_prefill=True, prefix_cache=True,
                                                 prefill_chunk_tokens=8,
                                                 prefill_impl="ss_fused"), {}))
SERVE_ROUTES.pop("frozen")   # no landmark state: frozen streaming has nothing to freeze


@pytest.mark.parametrize("route", sorted(SERVE_ROUTES))
def test_greedy_tokens_identical_to_jax_engine(weights, route):
    jcfg, jparams, cfg, params = weights
    serve_kw, model_kw = SERVE_ROUTES[route]
    (jout, jcalls, jst), (out, calls, st) = serve_both(
        jcfg, jparams, cfg, params, serve_kw, model_kw, prompts_for(cfg.vocab_size, n=3))
    assert sorted(out) == [0, 1, 2] and out == jout and calls == jcalls
    assert st["mode"] == jst["mode"] == "dense+replay-prefill"
    assert "kv" not in st and "kv" not in jst and "prefix" not in st
    assert st["decode_plan"] == jst["decode_plan"]


def test_chaos_plan_identical_to_jax_engine(weights):
    jcfg, jparams, cfg, params = weights
    runs = chaos_both(jcfg, jparams, cfg, params, rules=(("drop_sample", dict(rate=0.1)),))
    assert runs[0] == runs[1]
    assert runs[1][2] > 0 and set(runs[1][1].values()) == {"finished"}


def test_mlstm_gradients_finite_at_the_configs_chunk():
    from repro.train import train_step as jtrain_step

    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import make_grad_step

    jcfg, cfg = cfgs(ARCH, 2, ssm_chunk=256, **KW)
    jparams, params = both_params(jcfg)
    host = data_for(cfg, seq=256).batch(0)
    _, jgrads = jax.jit(jtrain_step.make_grad_step(jcfg))(jparams, jax_batch(host))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(jgrads))
    loss, grads = make_grad_step(cfg)(params, to_device(host, "cpu"))
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    jloss, jgrads = jax.jit(jtrain_step.make_grad_step(
        dataclasses.replace(jcfg, ssm_chunk=64)))(jparams, jax_batch(host))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for g, jg in zip(tree_leaves(grads), jax.tree.leaves(jgrads)):
        assert rel(g, jg) <= 1e-4


@pytest.mark.parametrize("n_layers", [1, 2], ids=["1_layer", "2_layers"])
def test_train_steps_match_jax(n_layers):
    jcfg, cfg = cfgs(ARCH, n_layers, ssm_chunk=16, **KW)
    data = data_for(cfg)
    check_train_parity(cfg, jax_train_run(jcfg, data), n_layers, data)


def test_trainer_and_launcher_train_xlstm(tmp_path):
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import Trainer

    cfg = base.reduced(registry.get_config(ARCH), **KW)
    trainer = Trainer(cfg, base.TrainConfig(checkpoint_dir=str(tmp_path)),
                      base.ShapeConfig("t", 48, 2, "train"), device="cpu")
    assert all(np.isfinite(h["loss"]) for h in trainer.run(2))
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                              "2", "--batch", "2", "--seq", "48"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
