"""Training the ``moe`` family on the port against the JAX reference, on
the CPU: reduced DeepSeek-V2-Lite (MLA + MoE, the config's own
capacity_factor 1.25, so tokens drop) and reduced Kimi-K2 (GQA + MoE at
capacity_factor 1.0 under ``spectral_shift_fused``: the port runs the
plain K1-K4 on the CPU, the reference its dispatch's CPU route, the
kernels' jnp math; ``tests/test_torch_train.py`` and
``tests/test_torch_kernels_bwd.py`` hold K1-K4 to the Pallas kernels in
interpret mode), weights from ``repro.models.params.init_params`` through
``params_from_numpy``, fp32.

* the configs equal to the reference's and registered in its order; the
  weight bridge round trip of reduced DeepSeek-V2-Lite, Kimi-K2 and
  Hymba-1.5B (every leaf bit for bit, the same paths and shapes) and the
  train cell's ``batch_specs``;
* ``mla_forward`` (the full-sequence, non-absorbed MLA the trainer runs)
  against the reference's for "full", "chunked" and "spectral_shift", at
  1e-5 of max-abs;
* one MoE layer: routing and the kept mask exact, output and aux at 5e-5
  of max-abs, and the gradients of a loss of (output, aux) with respect
  to the input and every MoE leaf, the router included, against
  ``jax.grad`` at 1e-4 (the load-balance term's expert counts carry no
  gradient in either package);
* the loss, the grad norm and every gradient leaf of one step, and the
  parameters after 3 steps of the port's ``make_train_step`` against
  ``jax.jit(repro.train.train_step.make_train_step)``, at 1 and 2 layers,
  with ``tests/test_torch_train.py``'s shapes (seq 96, batch 2) and
  bounds: one layer loss 1e-5 relative, grad norm and grads 1e-4 of each
  leaf's max-abs, the parameters' change over the 3 steps within 5e-2
  (max-abs) and 2e-3 (L2) of the reference's change; two layers (ROADMAP
  P1, P3) loss 1e-4, grad norm 1e-2, grads 3e-3, the change within 0.75
  and 0.1. Measured, one layer: grads 3.5e-6 (DeepSeek-V2-Lite) and
  2.9e-5 (Kimi-K2), change 1.9e-2 max-abs and 3.6e-4 L2; two layers:
  grads 2.9e-5 and 1.6e-4, change 0.56 (Kimi-K2's embedding, whose
  rarely seen rows AdamW moves by about lr either way, P3) and 5.2e-2 L2.
  The losses and grad norms of steps 1-2 are not held: Kimi-K2's grad
  norm grows tenfold after the first update and the two packages' grad
  norms spread by 3.2% at step 2 at two layers (P1); the parameters'
  change carries the trajectory. (At seq 64 the spread is wider: 6.6%,
  DeepSeek-V2-Lite's embedding change 1.03 max-abs, Kimi-K2's L2 9.8e-2.)
* the ``Trainer`` and the launcher on both configs, remat "full" against
  "none", and ``moe_impl="ep"`` on one device: ``moe_forward`` there, as
  the reference's ``moe_forward_ep`` falls back without a mesh
  (``tests/test_torch_ep.py`` holds it over ranks).
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
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro.train import train_step as jtrain_step  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models.params import (PATH_SEP, flatten_with_paths,  # noqa: E402
                                       params_from_numpy, tree_leaves)
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.train.train_step import make_grad_step, make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

SEQ, BATCH, STEPS = 96, 2, 3
TCFG = dict(warmup_steps=2, total_steps=10)
# (loss rel, grad-norm rel, grads of max-abs): test_torch_train.py's
TOL = {1: (1e-5, 1e-4, 1e-4), 2: (1e-4, 1e-2, 3e-3)}
# the parameters' change over the steps (max-abs gap, L2 gap), relative to
# the reference change's max-abs / L2 norm: test_torch_train.py's
CHANGE_TOL = {1: (5e-2, 2e-3), 2: (0.75, 0.1)}
ARCHS = {"deepseek": ("deepseek-v2-lite-16b", {}),
         "kimi": ("kimi-k2-1t-a32b", {"attention_impl": "spectral_shift_fused"})}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch: str, layers: int = 2, **kw):
    name, extra = ARCHS[arch]
    kw = dict(extra, num_layers=layers, **kw)
    return jbase.reduced(jget_config(name), **kw), base.reduced(get_config(name), **kw)


def _rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _weights(jcfg, seed=0):
    jparams = jinit_params(jmodel.model_specs(jcfg), jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def test_configs_mirror_jax():
    for arch in ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "hymba-1.5b"):
        assert arch in ARCH_IDS
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
    from repro.configs.registry import ARCH_IDS as JARCH_IDS

    assert ARCH_IDS == [a for a in JARCH_IDS if a in ARCH_IDS]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "hymba-1.5b"])
def test_weight_bridge_and_batch_specs_round_trip(arch):
    """The reference's ``init_params`` of the reduced config through
    ``params_from_numpy`` and back: the port's spec tree has the same
    paths and shapes, and every leaf (the MoE, MLA and mamba leaves and
    Hymba's gates included) returns bit for bit. The train cell's
    ``batch_specs`` equal the reference's."""
    from repro.configs import registry as jregistry
    from repro_torch.configs import registry
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import map_specs, params_to_numpy

    jcfg, cfg = jbase.reduced(jget_config(arch)), base.reduced(get_config(arch))
    jparams, params = _weights(jcfg)
    shapes = {}
    map_specs(lambda path, spec: shapes.__setitem__(path[1:].replace("/", PATH_SEP),
                                                    tuple(spec.shape)), model_specs(cfg))
    assert shapes == {path: tuple(t.shape) for path, t in flatten_with_paths(params).items()}
    back = params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    shape = registry.shape_preset("train_4k")
    specs, axes = registry.batch_specs(get_config(arch), shape)
    jspecs, jaxes = jregistry.batch_specs(jget_config(arch), jregistry.shape_preset("train_4k"))
    assert tuple(specs["tokens"].shape) == jspecs["tokens"].shape and axes == jaxes


# ==========================================================================
# mla_forward and one MoE layer
# ==========================================================================
@pytest.mark.parametrize("impl", ["full", "chunked", "spectral_shift"])
def test_mla_forward_matches_jax(impl):
    jcfg, cfg = _cfgs("deepseek")
    jparams, params = _weights(jcfg)
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["attn"])
    p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    x = np.random.default_rng(1).normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40))
    ref = jax.jit(lambda p_, x_, pos_: jattention.mla_forward(p_, jcfg, x_, pos_, impl=impl))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    out = attention.mla_forward(p, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                                impl=impl)
    assert _rel(out, ref) <= 1e-5


def _moe_layer(capacity_factor):
    jcfg, cfg = _cfgs("deepseek")
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jparams, params = _weights(jcfg)
    jp = jax.tree.map(lambda t: t[0], jparams["layers"]["moe"])
    p = jax.tree.map(lambda t: t[0], params["layers"]["moe"])
    x = np.random.default_rng(2).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


@pytest.mark.parametrize("capacity_factor", [1.25, 100.0], ids=["drops", "dropless"])
def test_moe_layer_forward_and_grads_match_jax(capacity_factor):
    jcfg, cfg, jp, p, x = _moe_layer(capacity_factor)
    gates, top_w, top_i = moe.route(p, cfg, torch.from_numpy(x))
    jgates = jax.nn.softmax((jnp.asarray(x) @ jp["router"]).astype(jnp.float32), -1)
    jtop_w, jtop_i = jax.lax.top_k(jgates, jcfg.top_k)
    assert top_i.tolist() == np.asarray(jtop_i).tolist()
    slot, keep = moe.dispatch_slots(cfg, top_i, x.shape[1])
    assert moe.capacity(cfg, x.shape[1]) == jmoe.capacity(jcfg, x.shape[1])
    assert bool((~keep).any()) == (capacity_factor < 2)

    def jloss(jp, xx):
        out, aux = jmoe.moe_forward(jp, jcfg, xx)
        return jnp.sum(out * out) + 3.0 * aux, (out, aux)

    (_, (jout, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tp = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
              if isinstance(v, dict) else v.clone().requires_grad_(True))
          for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_forward(tp, cfg, tx)
    assert _rel(out.detach(), jout) <= 5e-5
    assert abs(float(aux.detach()) - float(jaux)) <= 5e-5 * abs(float(jaux))
    (torch.sum(out * out) + 3.0 * aux).backward()
    assert _rel(tx.grad, jgx) <= 1e-4
    port_leaves, ref_leaves = tree_leaves(tp), jax.tree.leaves(jg)
    assert len(port_leaves) == len(ref_leaves) == 7  # router, 3 experts, 3 shared
    for t, r in zip(port_leaves, ref_leaves):
        assert _rel(t.grad, r) <= 1e-4


# ==========================================================================
# Train steps against jax.jit(make_train_step)
# ==========================================================================
def _jax_run(jcfg):
    jt = jbase.TrainConfig(**TCFG)
    lr_fn = jschedules.warmup_cosine(jt.learning_rate, jt.warmup_steps, jt.total_steps)
    params0 = jinit_params(jmodel.model_specs(jcfg), jax.random.PRNGKey(0))
    data = jpipeline.SyntheticLM(jcfg.vocab_size, SEQ, BATCH, seed=0)
    jloss0, jgrads0 = jax.jit(jtrain_step.make_grad_step(jcfg))(
        params0, {"tokens": jnp.asarray(data.batch(0)["tokens"])})
    step = jax.jit(jtrain_step.make_train_step(jcfg, jt, lr_fn))
    p, o, hist = params0, jadamw.adamw_init(params0), []
    for i in range(STEPS):
        p, o, m = step(p, o, {"tokens": jnp.asarray(data.batch(i)["tokens"])})
        hist.append({k: float(v) for k, v in m.items()})
    return dict(params0=params0, hist=hist, final=jax.tree.map(np.asarray, p),
                loss0=float(jloss0), grads0=jax.tree.map(np.asarray, jgrads0))


def check_train_parity(cfg, ref: dict, layers: int) -> None:
    """The port's grad step at the initial weights and 3 train steps
    against the reference's run ``ref`` (``_jax_run``)."""
    loss_tol, gn_tol, g_tol = TOL[layers]
    data = pipeline.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    params = params_from_numpy(jax.tree.map(np.asarray, ref["params0"]))
    loss, grads = make_grad_step(cfg)(params, pipeline.to_device(data.batch(0), "cpu"))
    assert float(loss) == pytest.approx(ref["loss0"], rel=loss_tol)
    jgrads = jax.tree.leaves(ref["grads0"])
    assert len(tree_leaves(grads)) == len(jgrads)
    for port, jg in zip(tree_leaves(grads), jgrads):
        assert _rel(port, jg) <= g_tol
    tcfg = base.TrainConfig(**TCFG)
    step = make_train_step(cfg, tcfg, schedules.warmup_cosine(
        tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps))
    opt = adamw.adamw_init(params)
    for i, h in enumerate(ref["hist"]):
        params, opt, m = step(params, opt, pipeline.to_device(data.batch(i), "cpu"))
        if i == 0:
            assert abs(float(m["loss"]) - h["loss"]) <= loss_tol * abs(h["loss"])
            assert abs(float(m["grad_norm"]) - h["grad_norm"]) <= gn_tol * h["grad_norm"]
    max_tol, l2_tol = CHANGE_TOL[layers]
    ref0 = jax.tree.map(np.asarray, ref["params0"])
    for path, port in flatten_with_paths(params).items():
        fin, r0 = _leaf(ref["final"], path), _leaf(ref0, path)
        gap, change = port.numpy() - fin, fin - r0
        assert np.abs(gap).max() <= max_tol * np.abs(change).max(), path
        assert np.linalg.norm(gap) <= l2_tol * np.linalg.norm(change), path


def _leaf(tree, path: str):
    for key in path.split(PATH_SEP):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("layers", [1, 2], ids=["1_layer", "2_layers"])
@pytest.mark.parametrize("arch", ["deepseek", "kimi"])
def test_train_steps_match_jax(arch, layers):
    jcfg, cfg = _cfgs(arch, layers)
    if arch == "deepseek":
        assert cfg.mla and cfg.capacity_factor == 1.25
    else:
        assert not cfg.mla and cfg.capacity_factor == 1.0
    check_train_parity(cfg, _jax_run(jcfg), layers)


# ==========================================================================
# Remat, Trainer, launcher, refusals
# ==========================================================================
@pytest.mark.parametrize("arch", ["deepseek", "kimi"])
def test_remat_full_matches_none(arch):
    _, cfg = _cfgs(arch)
    jparams, params = _weights(_cfgs(arch)[0])
    batch = pipeline.to_device(pipeline.SyntheticLM(cfg.vocab_size, SEQ, BATCH,
                                                    seed=0).batch(0), "cpu")
    out = {r: make_grad_step(dataclasses.replace(cfg, remat=r))(params, batch)
           for r in ("none", "full")}
    assert float(out["full"][0]) == pytest.approx(float(out["none"][0]), rel=1e-6)
    for a, b in zip(tree_leaves(out["full"][1]), tree_leaves(out["none"][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"])
def test_trainer_and_launcher_train_moe(tmp_path, arch):
    hist = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                              "2", "--batch", "2", "--seq", "48"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    cfg = base.reduced(get_config(arch))
    trainer = Trainer(cfg, base.TrainConfig(checkpoint_dir=str(tmp_path), **TCFG),
                      base.ShapeConfig("t", 48, 2, "train"), device="cpu")
    metrics = trainer.run(2)
    assert all(np.isfinite(m["loss"]) and m["aux"] > 0 for m in metrics)


def test_expert_parallel_moe_falls_back_without_a_mesh(tmp_path):
    """One single-device Trainer step under ``moe_impl="ep"`` equals the
    ``"gspmd"`` one bit for bit: off a mesh ``moe_forward_ep`` is
    ``moe_forward`` (``repro/models/moe.py:129``)."""
    _, cfg = _cfgs("kimi")
    runs = {}
    for impl in ("gspmd", "ep"):
        tr = Trainer(dataclasses.replace(cfg, moe_impl=impl),
                     base.TrainConfig(checkpoint_dir=str(tmp_path / impl), **TCFG),
                     base.ShapeConfig("t", SEQ, BATCH, "train"), device="cpu")
        runs[impl] = (tr.run(1)[0], tree_leaves(tr.params))
    (m_g, p_g), (m_e, p_e) = runs["gspmd"], runs["ep"]
    assert m_e["loss"] == m_g["loss"] and m_e["aux"] == m_g["aux"] > 0
    for a, b in zip(p_e, p_g):
        assert torch.equal(a, b)
