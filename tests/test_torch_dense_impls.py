"""The rest of the dense family's attention, through the model and the
trainer, against the JAX reference on the CPU.

* Loss and every gradient leaf of one grad step (``make_grad_step``, the
  reference's ``loss_fn`` under ``jax.grad``; its Trainer fails on this
  tree, ROADMAP R1) for reduced Qwen2-7B and reduced paper-bert, one fp32
  layer, the reference's own weights, under ``attention_impl`` "chunked",
  "spectral_shift", "nystrom" and "spectral_shift_fused" (the port's
  kernels' plain versions through dispatch; the reference's jnp route,
  ``attention_backend="jnp"``: its kernels in interpret mode are held in
  ``tests/test_torch_train.py``).
* A ``Trainer`` smoke (two steps, finite, falling-or-flat loss is not
  asked) for each of those impls, and with ``opt_state_dtype="bfloat16"``,
  which the port now accepts as the reference does.
* ``nystrom_attention_fused`` (K1 / K2 with delta = 0) against the
  reference's plain ``nystrom_attention``; K5' ``paged_row_stats`` (one
  lane) against ``repro.kernels.paged_decode.paged_row_stats`` in
  interpret mode.
* The configs: paper-bert, qwen2-72b and deepseek-67b equal the
  reference's field for field; ``list_archs``, ``shape_preset`` and
  ``batch_specs``.

Tolerances: loss 1e-5 relative and each grad leaf 1e-4 of its max-abs (as
``tests/test_torch_train.py`` at one layer); the attention calls 2e-5 of
the reference's max-abs (the Newton-Schulz core, ROADMAP Queue 3 P1);
K5' 1e-5 (one fp32 softmax).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core.attention import nystrom_attention as jnystrom  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels.paged_decode import paged_row_stats as jpaged_row_stats  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.train import train_step as jtrain_step  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.core.attention import SSConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ops import nystrom_attention_fused  # noqa: E402
from repro_torch.kernels.paged_decode import paged_row_stats  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.train.train_step import make_grad_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

SEQ, BATCH = 96, 2
IMPLS = ("chunked", "spectral_shift", "nystrom", "spectral_shift_fused")
ARCHS = ("qwen2-7b", "paper-bert")


def _rel_err(port, ref) -> float:
    port = port.detach().double().numpy() if isinstance(port, torch.Tensor) else port
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _cfgs(arch: str, impl: str):
    kw = dict(num_layers=1, attention_impl=impl)
    return (jbase.reduced(jregistry.get_config(arch), attention_backend="jnp", **kw),
            base.reduced(registry.get_config(arch), **kw))


@pytest.fixture(scope="module", params=ARCHS)
def arch_weights(request):
    jcfg, _ = _cfgs(request.param, "full")
    jparams = jinit_params(jmodel.model_specs(jcfg), jax.random.PRNGKey(0))
    data = jpipeline.SyntheticLM(jcfg.vocab_size, SEQ, BATCH, seed=0).batch(0)
    return request.param, jparams, data


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grads_match_jax(arch_weights, impl, monkeypatch):
    arch, jparams, batch = arch_weights
    jcfg, cfg = _cfgs(arch, impl)
    jloss, jgrads = jax.jit(jtrain_step.make_grad_step(jcfg))(
        jparams, {"tokens": jnp.asarray(batch["tokens"])})
    calls = []
    for name in ("landmark_summary", "landmark_summary_bwd"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    loss, grads = make_grad_step(cfg)(params_from_numpy(jax.tree.map(np.asarray, jparams)),
                                      pipeline.to_device(batch, "cpu"))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref_leaves = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    port_leaves = tree_leaves(grads)
    assert len(port_leaves) == len(ref_leaves)
    for g, r in zip(port_leaves, ref_leaves):
        assert _rel_err(g, r) <= 1e-4
    # only the fused impl goes through the kernels' wrappers (their plain
    # versions here), forward and backward once for the one layer
    fused = impl == "spectral_shift_fused"
    assert calls == (["landmark_summary", "landmark_summary_bwd"] if fused else [])


@pytest.mark.parametrize("impl,opt_dtype", [(impl, "float32") for impl in IMPLS]
                         + [("spectral_shift_fused", "bfloat16")])
def test_trainer_runs_each_impl(tmp_path, impl, opt_dtype):
    cfg = base.reduced(registry.get_config("paper-bert"), num_layers=1,
                       attention_impl=impl)
    tcfg = base.TrainConfig(checkpoint_dir=str(tmp_path), checkpoint_every=0,
                            warmup_steps=1, total_steps=4, opt_state_dtype=opt_dtype)
    trainer = Trainer(cfg, tcfg, base.ShapeConfig("t", 80, 2, "train"), device="cpu")
    hist = trainer.run(2)
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)


@pytest.mark.parametrize("causal", [False, True])
def test_nystrom_attention_fused_matches_jax(causal):
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 2, 160, 32)).astype(np.float32) * s
               for s in (0.5, 0.5, 1.0))
    ref = jnystrom(*map(jnp.asarray, (q, k, v)), num_landmarks=16, causal=causal)
    out = nystrom_attention_fused(*map(torch.from_numpy, (q, k, v)),
                                  SSConfig(num_landmarks=16, causal=causal))
    assert _rel_err(out, ref) < 2e-5


@pytest.mark.parametrize("kv_valid", [0, 13, 37])
def test_paged_row_stats_single_lane_matches_jax(kv_valid):
    rng = np.random.default_rng(kv_valid)
    hkv, r, d, bs, nb = 2, 7, 32, 8, 12
    q = rng.normal(size=(hkv, r, d)).astype(np.float32) * 0.5
    k_pool = rng.normal(size=(hkv, nb, bs, d)).astype(np.float32) * 0.5
    v_pool = rng.normal(size=(hkv, nb, bs, 16)).astype(np.float32)
    table = np.zeros(6, np.int32)
    table[:5] = rng.permutation(np.arange(1, nb))[:5]
    ref = jpaged_row_stats(jnp.asarray(q), (jnp.asarray(k_pool),), jnp.asarray(v_pool),
                           jnp.asarray(table), kv_valid, scale=0.2, block_size=bs,
                           interpret=True)
    out = paged_row_stats(torch.from_numpy(q), (torch.from_numpy(k_pool),),
                          torch.from_numpy(v_pool), torch.from_numpy(table), kv_valid,
                          scale=0.2, block_size=bs)
    for o, rf in zip(out, ref):
        assert o.shape == rf.shape
        if kv_valid:
            assert _rel_err(o, rf) < 1e-5
        else:   # the anchor: m = -1e30, l = 0, acc = 0
            np.testing.assert_array_equal(o.numpy(), np.asarray(rf))


@pytest.mark.parametrize("arch", ["paper-bert", "qwen2-72b", "deepseek-67b"])
def test_configs_equal_the_reference(arch):
    port, ref = registry.get_config(arch), jregistry.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_registry_helpers():
    assert set(registry.list_archs()) <= set(jregistry.list_archs())
    assert {"qwen2-72b", "qwen2-7b", "deepseek-67b"} <= set(registry.list_archs())
    assert registry.shape_preset("train_4k") == base.SHAPE_PRESETS["train_4k"]
    cfg = registry.get_config("paper-bert")
    shape = registry.shape_preset("train_4k")
    specs, axes = registry.batch_specs(cfg, shape)
    jspecs, jaxes = jregistry.batch_specs(jregistry.get_config("paper-bert"),
                                          jregistry.shape_preset("train_4k"))
    assert tuple(specs["tokens"].shape) == jspecs["tokens"].shape
    assert str(specs["tokens"].dtype).removeprefix("torch.") == jspecs["tokens"].dtype.name
    assert axes == jaxes
    with pytest.raises(KeyError, match="unknown architecture"):
        registry.get_config("rwkv-7b")
