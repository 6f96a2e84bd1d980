"""LLaVA-NeXT-34B (family ``vlm``) on the port against the JAX reference,
on the CPU.

Reduced LLaVA-NeXT-34B (d_model 128, 4 query heads on 1 kv head of 32,
c = 16, 16 stub patches of 1024 features), fp32, weights from
``repro.models.params.init_params`` through ``params_from_numpy``, inputs
from numpy seeds:

* the config and ``batch_specs`` (p = min(2880, s / 2) patches beside
  s - p tokens) equal the reference's; the parameter tree (``mm_proj``)
  and the cache tree (the dense family's) too;
* ``model_forward`` with patches (the gelu projector's output put ahead
  of the token embeddings) at 1 layer (5e-5 of max-abs; measured 1.1e-5)
  and 2 layers (5e-4; 1.8e-4, ROADMAP P1), under ``chunked`` and
  ``spectral_shift_fused``; ``loss_fn`` (labels on the text positions
  only) at 1e-5;
* greedy tokens, every ``on_token`` call and ``stats()`` of
  ``ServeEngine(device="cpu")`` identical to the JAX engine's, text
  prompts only, as the reference's engine serves the family: the default
  route, ``ss_fused`` + ``paged`` (the K1 / K2 prefill and K5 decode
  routes, their plain versions here), ``paged=False``, frozen streaming
  (and its rebases), the chunked tick (chunks of 8 over prompts of 10-29),
  the prefix cache (A, B, A: one hit, equal prefix stats) and one chaos
  plan; modes ``paged+batched-prefill`` / ``paged+chunked-prefill``;
* the loss, grad norm and every gradient of one step and the parameters'
  change over 3 steps against ``jax.jit(make_train_step)`` at 1 and 2
  layers, under ``chunked`` and ``spectral_shift_fused`` (seq 96: 16
  patches + 80 tokens, batch 2), the step at ``tests/test_torch_train.py``'s
  bounds. The change is held at its two-layer bounds (0.75 max-abs, 0.1
  L2) at one layer and at (2.0, 0.5) at two: the projected patches
  (std ~0.7) sit beside token embeddings of std 0.02, and AdamW moves the
  embedding rows and ``mm_proj/w1`` entries whose gradients are near zero
  by about lr either way (ROADMAP P3); at two layers the grad norms spread
  2-3% by steps 1-2, as Kimi-K2's do (P1). Measured change: one layer
  0.21 / 3.3e-3 (chunked), 2.3e-2 / 1.8e-4 (fused); two layers 1.25 /
  0.18 and 1.31 / 0.25, worst on ``embed`` and ``mm_proj/w1``; step-0
  grads 2.3e-5 and 7.4e-4 / 2.1e-3 of max-abs. A leaf the port left
  untrained would show an L2 gap of 1.0;
* the ``Trainer`` and the launcher.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.models import model  # noqa: E402
from test_torch_whisper import (ROUTES, both_params, cfgs, chaos_both,  # noqa: E402
                                check_train_parity, data_for, jax_batch,
                                jax_train_run, prompts_for, rel, serve_both,
                                tree_shapes_match)

ARCH = "llava-next-34b"
LOGIT_TOL = {1: 5e-5, 2: 5e-4}
# the parameters' change over 3 steps (max-abs gap, L2 gap): see above
CHANGE_TOL = {1: (0.75, 0.1), 2: (2.0, 0.5)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = cfgs(ARCH)
    jparams, params = both_params(jcfg)
    return jcfg, jparams, cfg, params


def test_config_batch_specs_and_trees_equal_the_reference(weights):
    jcfg, jparams, cfg, params = weights
    assert (dataclasses.asdict(registry.get_config(ARCH))
            == dataclasses.asdict(jregistry.get_config(ARCH)))
    for s in (4096, 32768):
        shape = base.ShapeConfig("t", s, 2, "train")
        specs, axes = registry.batch_specs(registry.get_config(ARCH), shape)
        jspecs, jaxes = jregistry.batch_specs(jregistry.get_config(ARCH), shape)
        assert axes == jaxes
        assert {k: tuple(v.shape) for k, v in specs.items()} == {
            k: v.shape for k, v in jspecs.items()}
        assert {k: str(v.dtype).removeprefix("torch.") for k, v in specs.items()} == {
            k: v.dtype.name for k, v in jspecs.items()}
    tree_shapes_match(cfg, jparams)
    assert set(params["mm_proj"]) == {"w1", "w2"}


@pytest.mark.parametrize("impl", ["chunked", "spectral_shift_fused"])
@pytest.mark.parametrize("n_layers", [1, 2], ids=["1_layer", "2_layers"])
def test_model_forward_with_patches_and_loss_match_jax(n_layers, impl):
    jcfg, cfg = cfgs(ARCH, n_layers, attention_impl=impl)
    jparams, params = both_params(jcfg)
    host = data_for(cfg, seq=56).batch(0)
    assert host["patches"].shape == (2, cfg.num_patches, 1024)
    jlogits, _ = jax.jit(lambda p_, b_: jmodel.model_forward(p_, jcfg, b_))(
        jparams, jax_batch(host))
    logits, aux = model.model_forward(params, cfg, to_device(host, "cpu"))
    assert logits.shape[1] == 56
    assert rel(logits, jlogits) <= LOGIT_TOL[n_layers]
    assert float(aux) == 0.0
    jloss, _ = jmodel.loss_fn(jparams, jcfg, jax_batch(host))
    loss, metrics = model.loss_fn(params, cfg, to_device(host, "cpu"))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_greedy_tokens_identical_to_jax_engine(weights, route):
    jcfg, jparams, cfg, params = weights
    serve_kw, model_kw = ROUTES[route]
    (jout, jcalls, jst), (out, calls, st) = serve_both(
        jcfg, jparams, cfg, params, serve_kw, model_kw, prompts_for(cfg.vocab_size))
    assert sorted(out) == [0, 1] and out == jout and calls == jcalls
    for key in ("mode", "decode_impl", "decode_streaming", "preemptions"):
        assert st[key] == jst[key]
    assert st["mode"] == ("dense+replay-prefill" if route == "dense"
                          else "paged+batched-prefill")
    if route == "frozen":
        assert st["rebases"] == jst["rebases"] > 0


@pytest.mark.parametrize("streaming", ["exact", "frozen"])
def test_chunked_tick_identical_to_jax_engine(weights, streaming):
    jcfg, jparams, cfg, params = weights
    kw = dict(chunked_prefill=True, prefill_chunk_tokens=8, prefill_impl="ss_fused",
              decode_impl="paged")
    prompts = prompts_for(cfg.vocab_size, n=3, lo=10, hi=30)
    (jout, jcalls, jst), (out, calls, st) = serve_both(
        jcfg, jparams, cfg, params, kw, dict(decode_streaming=streaming), prompts)
    assert sorted(out) == [0, 1, 2] and out == jout and calls == jcalls
    assert st["mode"] == jst["mode"] == "paged+chunked-prefill"
    assert st["chunks"] > len(prompts)


def test_prefix_cache_identical_to_jax_engine(weights):
    jcfg, jparams, cfg, params = weights
    a, b = prompts_for(cfg.vocab_size, n=2, seed=3, lo=20, hi=30)
    kw = dict(prefix_cache=True, prefill_chunk_tokens=8, prefill_impl="ss_fused",
              decode_impl="paged")
    (jout, jcalls, jst), (out, calls, st) = serve_both(
        jcfg, jparams, cfg, params, kw, {}, [a, b, a])
    assert out == jout and calls == jcalls
    assert st["prefix"] == jst["prefix"] and st["prefix"]["hits"] >= 1


def test_chaos_plan_identical_to_jax_engine(weights):
    jcfg, jparams, cfg, params = weights
    runs = chaos_both(jcfg, jparams, cfg, params)
    assert runs[0] == runs[1]
    assert runs[1][2] > 0 and set(runs[1][1].values()) == {"finished"}


@pytest.mark.parametrize("impl", ["chunked", "spectral_shift_fused"])
@pytest.mark.parametrize("n_layers", [1, 2], ids=["1_layer", "2_layers"])
def test_train_steps_match_jax(n_layers, impl):
    jcfg, cfg = cfgs(ARCH, n_layers, attention_impl=impl)
    data = data_for(cfg)
    check_train_parity(cfg, jax_train_run(jcfg, data), n_layers, data,
                       change_tol=CHANGE_TOL[n_layers])


def test_trainer_and_launcher_train_llava(tmp_path):
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import Trainer

    cfg = base.reduced(registry.get_config(ARCH))
    trainer = Trainer(cfg, base.TrainConfig(checkpoint_dir=str(tmp_path)),
                      base.ShapeConfig("t", 48, 2, "train"), device="cpu",
                      data=data_for(cfg, seq=48))
    assert all(np.isfinite(h["loss"]) for h in trainer.run(2))
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
                              "2", "--batch", "2", "--seq", "48",
                              "--attention", "spectral_shift_fused"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
