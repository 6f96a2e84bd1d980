"""The port's training path against the JAX reference, on the CPU.

Oracles. The reference ``Trainer`` fails under its mesh on this tree
(ROADMAP R1), so the port is held at the step level: its
``make_train_step`` against ``jax.jit(repro.train.train_step.
make_train_step(...))`` with no mesh, its ``make_grad_step`` against the
reference's, on the same weights (``init_params`` -> numpy ->
``params_from_numpy``) and the same ``SyntheticLM`` batches, with reduced
Qwen2-7B at ``attention_impl="spectral_shift_fused"`` (the JAX side with
``attention_backend="interpret"``: the Pallas kernels in interpret mode).

Tolerances. One layer: loss at 1e-5 relative, grads at 1e-4 of each
leaf's max-abs, parameters after 3 AdamW steps at 1e-4 of each leaf's
max-abs plus 1e-2 of the summed learning rate. The second term is Adam's:
m / sqrt(v) of an entry whose gradient sits at rounding level (the QKV
biases start at zero, so their max-abs is the updates' own size) turns a
1e-5 gradient difference into a step difference of up to lr. Two layers
(ROADMAP P1, the spectral core amplifies rounding with depth; measured
spread: loss 1.7e-5, grad norm 2.4e-3, grads 8.7e-4, parameters 6.3e-3):
loss 1e-4, grad norm 1e-2, grads 3e-3, parameters 1e-2 plus 3e-2 of the
summed learning rate, which on the weight leaves exceeds the whole update.

The parameters' change over the 3 steps (p3 - p0, about 7.4e-4 at most,
far below the parameters' own max-abs) is held against the
reference's change on each leaf, at both depths: its max-abs gap relative
to the reference change's max-abs, and its L2 gap relative to the
reference change's L2 norm. A missing update scores 1 on both. Measured:
one layer 1.2e-2 (embed) and 6.2e-4 (b_k); two layers 0.49 and 2.5e-2,
both on embed, whose worst entries flip sign: Adam's first step on an
entry moves it by about lr * sign(g), and an entry whose gradient lies
within the rounding spread of zero moves the other way (ROADMAP P3).
Bounds: one layer 5e-2 and 2e-3; two layers 0.75 and 0.1. The Trainer's
restart is held bit-exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro.train import train_step as jtrain_step  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention, model  # noqa: E402
from repro_torch.models.params import (params_from_numpy, params_to_numpy,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.train import losses  # noqa: E402
from repro_torch.train.train_step import (make_eval_step, make_grad_step,  # noqa: E402
                                          make_train_step)
from repro_torch.train.trainer import Trainer  # noqa: E402

SEQ, BATCH, STEPS = 96, 2, 3
TCFG = dict(warmup_steps=2, total_steps=10)
# (loss rel, grad-norm rel, grads of max-abs, params of max-abs, params of sum lr)
TOL = {1: (1e-5, 1e-4, 1e-4, 1e-4, 1e-2), 2: (1e-4, 1e-2, 3e-3, 1e-2, 3e-2)}
# the parameters' change over the steps: (max-abs gap, L2 gap), each relative
# to the reference change's own max-abs / L2 norm
CHANGE_TOL = {1: (5e-2, 2e-3), 2: (0.75, 0.1)}


def _cfgs(layers: int, **kw):
    kw = dict(num_layers=layers, attention_impl="spectral_shift_fused", **kw)
    return (jbase.reduced(jget_config("qwen2-7b"), attention_backend="interpret", **kw),
            base.reduced(get_config("qwen2-7b"), **kw))


def _jax_params(jcfg):
    return jinit_params(jmodel.model_specs(jcfg), jax.random.PRNGKey(0))


def _port_params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams))


def _rel_err(port, ref) -> float:
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module", params=[1, 2], ids=["1_layer", "2_layers"])
def jax_run(request):
    """The reference's jitted train step, 3 steps, plus its grad step at the
    initial weights (one compile each per depth)."""
    layers = request.param
    jcfg, cfg = _cfgs(layers)
    jt = jbase.TrainConfig(**TCFG)
    lr_fn = jschedules.warmup_cosine(jt.learning_rate, jt.warmup_steps, jt.total_steps)
    params0 = _jax_params(jcfg)
    data = jpipeline.SyntheticLM(jcfg.vocab_size, SEQ, BATCH, seed=0)
    jloss0, jgrads0 = jax.jit(jtrain_step.make_grad_step(jcfg))(
        params0, {"tokens": jnp.asarray(data.batch(0)["tokens"])})
    step = jax.jit(jtrain_step.make_train_step(jcfg, jt, lr_fn))
    p, o, hist = params0, jadamw.adamw_init(params0), []
    for i in range(STEPS):
        p, o, m = step(p, o, {"tokens": jnp.asarray(data.batch(i)["tokens"])})
        hist.append({k: float(v) for k, v in m.items()})
    return dict(layers=layers, cfg=cfg, params0=params0, hist=hist,
                final=jax.tree.map(np.asarray, p), loss0=float(jloss0),
                grads0=jax.tree.map(np.asarray, jgrads0))


def test_train_step_matches_jax(jax_run):
    loss_tol, gn_tol, _, p_tol, lr_tol = TOL[jax_run["layers"]]
    cfg = jax_run["cfg"]
    tcfg = base.TrainConfig(**TCFG)
    lr_fn = schedules.warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps,
                                    tcfg.total_steps)
    params = _port_params(jax_run["params0"])
    opt = adamw.adamw_init(params)
    step = make_train_step(cfg, tcfg, lr_fn)
    data = pipeline.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    lr_sum = 0.0
    for i, ref in enumerate(jax_run["hist"]):
        params, opt, m = step(params, opt, pipeline.to_device(data.batch(i), "cpu"))
        assert abs(float(m["loss"]) - ref["loss"]) <= loss_tol * abs(ref["loss"])
        assert abs(float(m["grad_norm"]) - ref["grad_norm"]) <= gn_tol * ref["grad_norm"]
        assert float(m["lr"]) == pytest.approx(ref["lr"], rel=1e-6)
        lr_sum += ref["lr"]
    assert int(opt.step) == STEPS
    max_tol, l2_tol = CHANGE_TOL[jax_run["layers"]]
    leaves = tree_leaves(params)
    ref0 = jax.tree.leaves(jax.tree.map(np.asarray, jax_run["params0"]))
    assert len(leaves) == len(ref0) == len(jax.tree.leaves(jax_run["final"]))
    for port, ref, r0 in zip(leaves, jax.tree.leaves(jax_run["final"]), ref0):
        port = port.numpy()
        assert np.abs(port - ref).max() <= p_tol * np.abs(ref).max() + lr_tol * lr_sum
        # p3 - r3 is the gap between the two changes, as both start at r0
        gap, change = port - ref, ref - r0
        assert np.abs(gap).max() <= max_tol * np.abs(change).max()
        assert np.linalg.norm(gap) <= l2_tol * np.linalg.norm(change)


def test_grad_step_matches_jax(jax_run):
    _, _, g_tol, _, _ = TOL[jax_run["layers"]]
    cfg = jax_run["cfg"]
    data = pipeline.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    loss, grads = make_grad_step(cfg)(_port_params(jax_run["params0"]),
                                      pipeline.to_device(data.batch(0), "cpu"))
    assert float(loss) == pytest.approx(jax_run["loss0"], rel=TOL[jax_run["layers"]][0])
    for port, ref in zip(tree_leaves(grads), jax.tree.leaves(jax_run["grads0"])):
        assert port.dtype == torch.float32
        assert _rel_err(port, ref) <= g_tol


def _one_layer_port(**overrides):
    jcfg, cfg = _cfgs(1)
    cfg = dataclasses.replace(cfg, **overrides)
    params = _port_params(_jax_params(jcfg))
    data = pipeline.SyntheticLM(cfg.vocab_size, SEQ, 4, seed=0)
    return cfg, params, pipeline.to_device(data.batch(0), "cpu")


def test_microbatches_match_one_batch():
    cfg, params, batch = _one_layer_port()
    lr_fn = schedules.constant(1e-3)
    out = {}
    for mb in (1, 2):
        tcfg = base.TrainConfig(microbatches=mb)
        p = tree_map(lambda t: t.clone(), params)
        p, _, m = make_train_step(cfg, tcfg, lr_fn)(p, adamw.adamw_init(p), batch)
        out[mb] = (float(m["loss"]), float(m["grad_norm"]), p)
    assert out[2][0] == pytest.approx(out[1][0], rel=1e-6)
    assert out[2][1] == pytest.approx(out[1][1], rel=1e-5)
    for a, b in zip(tree_leaves(out[2][2]), tree_leaves(out[1][2])):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-2 * 1e-3


def test_eval_step_matches_the_grad_step_loss():
    cfg, params, batch = _one_layer_port()
    loss, metrics = make_eval_step(cfg)(params, batch)
    assert not loss.requires_grad and sorted(metrics) == ["aux", "ce", "ppl_proxy",
                                                          "tokens"]
    assert float(loss) == float(make_grad_step(cfg)(params, batch)[0])


def test_remat_full_matches_none():
    cfg, params, batch = _one_layer_port(num_layers=1)
    grads = {}
    for remat in ("none", "full"):
        loss, grads[remat] = make_grad_step(dataclasses.replace(cfg, remat=remat))(
            params, batch)
    for a, b in zip(tree_leaves(grads["full"]), tree_leaves(grads["none"])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


def _grads_by_remat(cfg, params, batch, policies):
    return {remat: make_grad_step(dataclasses.replace(cfg, remat=remat))(params, batch)
            for remat in policies}


@pytest.mark.parametrize("remat", ["dots", "ss_stats", "auto"])
def test_remat_policies_match_none(remat):
    """The selective-checkpoint policies (and "auto", which resolves to
    "full" on the CPU) give the loss and every gradient of remat="none" to
    1e-6 of each leaf's max-abs, at 2 layers so a layer's recompute feeds
    the next one's backward."""
    jcfg, cfg = _cfgs(2)
    params = _port_params(_jax_params(jcfg))
    batch = pipeline.to_device(pipeline.SyntheticLM(cfg.vocab_size, SEQ, 4, seed=0).batch(0),
                               "cpu")
    out = _grads_by_remat(cfg, params, batch, ("none", remat))
    (loss0, g0), (loss1, g1) = out["none"], out[remat]
    assert float(loss1) == pytest.approx(float(loss0), rel=1e-6)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


def _policy_decisions(monkeypatch, remat):
    """Run one grad step under ``remat`` and record the policy's decision
    for each op of the first (not the recomputed) forward."""
    from torch.utils.checkpoint import CheckpointPolicy

    seen = []
    policy = model.REMAT_POLICIES[remat]

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((str(op), decision == CheckpointPolicy.MUST_SAVE))
        return decision

    monkeypatch.setitem(model.REMAT_POLICIES, remat, spy)
    cfg, params, batch = _one_layer_port(remat=remat)
    make_grad_step(cfg)(params, batch)
    return seen


def test_ss_stats_saves_only_the_landmark_summary_op(monkeypatch):
    seen = _policy_decisions(monkeypatch, "ss_stats")
    saved = {op for op, keep in seen if keep}
    assert saved == {"repro_torch.landmark_summary.default"}
    assert any(op == "repro_torch.query_side.default" and not keep for op, keep in seen)


def test_dots_saves_the_products_with_no_batch_dims(monkeypatch):
    seen = _policy_decisions(monkeypatch, "dots")
    saved = [op for op, keep in seen if keep]
    # q, k, v, o and the MLP's gate, up, down: 7 products, all aten.mm
    assert saved == ["aten.mm.default"] * 7
    assert any(op == "aten.bmm.default" for op, _ in seen)
    assert not any("bmm" in op or "repro_torch" in op for op in saved)


def test_model_level_ss_stats_remat_matches_jax():
    """``tests/test_kernel_grads.py``'s ``test_model_level_ss_stats_remat``
    replayed: reduced qwen2-7b with 8 landmarks, tokens from
    PRNGKey(1). The port's ss_stats grads equal its remat="none" grads to
    1e-6 of max-abs, and match the reference's ss_stats grads within
    ``TOL[2]``'s grad bound, 3e-3 of each leaf's max-abs: the cross-package
    bound at two layers, where the random-weight model amplifies rounding."""
    from repro.train.train_step import make_grad_step as jmake_grad_step

    jcfg, cfg = _cfgs(2, num_landmarks=8)
    jparams = _jax_params(jcfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0, jcfg.vocab_size)
    _, jgrads = jax.jit(jmake_grad_step(dataclasses.replace(jcfg, remat="ss_stats")))(
        jparams, {"tokens": tokens})
    batch = {"tokens": torch.tensor(np.asarray(tokens), dtype=torch.long)}
    out = _grads_by_remat(cfg, _port_params(jparams), batch, ("none", "ss_stats"))
    for a, b, r in zip(tree_leaves(out["ss_stats"][1]), tree_leaves(out["none"][1]),
                       jax.tree.leaves(jgrads)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))
        assert _rel_err(a, r) <= TOL[2][2]


def test_custom_ops_pass_opcheck():
    rng = np.random.default_rng(21)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.5)  # noqa: E731
    q_l, k, v = t(2, 8, 16), t(2, 40, 16), t(2, 40, 16)
    for args in ((q_l, k, v, 0.25, False, None), (q_l, k, v, 0.25, True, 33)):
        torch.library.opcheck(ops.landmark_summary_stats,
                              tuple(a.requires_grad_(True) if isinstance(a, torch.Tensor)
                                    else a for a in args))
    q, k_l, m_mat, vq = t(2, 40, 16), t(2, 8, 16), t(2, 8, 16), t(2, 40, 16)
    delta = torch.full((2, 1, 1), 0.1)
    for causal in (False, True):
        torch.library.opcheck(ops.query_side_differentiable,
                              (q.requires_grad_(True), k_l.requires_grad_(True),
                               m_mat.requires_grad_(True), vq.requires_grad_(True),
                               delta.requires_grad_(True), 0.25, causal, 40))


def test_core_attention_full_matches_jax_and_rejects_unported():
    jcfg, cfg = _cfgs(1)
    jcfg = dataclasses.replace(jcfg, attention_impl="full")
    cfg = dataclasses.replace(cfg, attention_impl="full")
    jparams = _jax_params(jcfg)
    tokens = pipeline.SyntheticLM(cfg.vocab_size, 40, 2, seed=1).batch(0)["tokens"]
    jlogits, _ = jmodel.model_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    logits, _ = model.model_forward(_port_params(jparams), cfg,
                                    pipeline.to_device({"tokens": tokens}, "cpu"))
    assert _rel_err(logits, jlogits) <= 1e-5
    # every impl of the dense family is ported (tests/test_torch_dense_impls.py);
    # what is left to reject is a name the reference rejects too
    q = torch.zeros(1, 4, 8, 32)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention._core_attention(cfg, "linformer", q, q, q, causal=True)


# --------------------------------------------------------------------------
# Pieces of the step: loss, schedules, AdamW, data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("z_loss,smoothing", [(0.0, 0.0), (1e-3, 0.0), (0.0, 0.1),
                                              (1e-3, 0.1)])
def test_next_token_loss_matches_jax(z_loss, smoothing):
    rng = np.random.default_rng(21)
    logits = rng.standard_normal((2, 12, 50)).astype(np.float32) * 3
    tokens = rng.integers(0, 50, size=(2, 12)).astype(np.int32)
    tokens[:, -3:] = 0  # padding
    jl, jm = jlosses.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens),
                                     z_loss=z_loss, label_smoothing=smoothing)
    tl, tm = losses.next_token_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                                    z_loss=z_loss, label_smoothing=smoothing)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


def test_schedules_match_jax():
    fns = [(schedules.warmup_cosine(3e-4, 5, 20), jschedules.warmup_cosine(3e-4, 5, 20)),
           (schedules.constant(1e-3), jschedules.constant(1e-3))]
    for port, ref in fns:
        for step in range(25):
            got = float(port(torch.tensor(step, dtype=torch.int32)))
            assert got == pytest.approx(float(ref(jnp.asarray(step, jnp.int32))),
                                        rel=1e-6)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(22)
    tree = {"a": rng.standard_normal((4, 6)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    grads = jax.tree.map(lambda x: (x * 3).astype(np.float32), tree)
    tcfg, jtcfg = base.TrainConfig(grad_clip=0.5), jbase.TrainConfig(grad_clip=0.5)
    jp, js, jm = jadamw.adamw_update(grads, jadamw.adamw_init(tree), tree, jtcfg,
                                     jschedules.constant(1e-2))
    params = params_from_numpy(tree)
    p, s, m = adamw.adamw_update(params_from_numpy(grads), adamw.adamw_init(params),
                                 params, tcfg, schedules.constant(1e-2))
    assert p is params and int(s.step) == int(js.step) == 1
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    for a, b in zip(tree_leaves([p, s.m, s.v]), jax.tree.leaves([jp, js.m, js.v])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_data_sources_match_jax(tmp_path):
    text = tmp_path / "corpus.txt"
    text.write_bytes(bytes(range(256)) * 20)
    for port, ref in ((pipeline.SyntheticLM(512, 64, 3, seed=5),
                       jpipeline.SyntheticLM(512, 64, 3, seed=5)),
                      (pipeline.TextFileLM(str(text), 32, 3, seed=5),
                       jpipeline.TextFileLM(str(text), 32, 3, seed=5))):
        for step in (0, 7):
            np.testing.assert_array_equal(port.batch(step)["tokens"],
                                          ref.batch(step)["tokens"])
    batch = pipeline.to_device(pipeline.SyntheticLM(512, 8, 2).batch(0), "cpu")
    assert batch["tokens"].dtype == torch.int64


# --------------------------------------------------------------------------
# Checkpoints and the Trainer
# --------------------------------------------------------------------------
def _jax_state():
    jcfg, _ = _cfgs(1)
    jparams = _jax_params(jcfg)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.5), jparams)
    jt, lr_fn = jbase.TrainConfig(), jschedules.constant(1e-3)
    p, o, _ = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, jt, lr_fn))(
        grads, jadamw.adamw_init(jparams), jparams)
    return {"params": p, "opt": o}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    jstate = _jax_state()
    host = jax.tree.map(np.asarray, jstate)
    state = {"params": params_from_numpy(host["params"]),
             "opt": adamw.AdamWState(step=torch.tensor(int(host["opt"].step),
                                                       dtype=torch.int32),
                                     m=params_from_numpy(host["opt"].m),
                                     v=params_from_numpy(host["opt"].v))}
    if writer == "jax":
        JCheckpointer(str(tmp_path)).save(1, jstate)
        restored = Checkpointer(str(tmp_path)).restore(1, state)
        got = [t.numpy() for t in tree_leaves(restored)]
    else:
        Checkpointer(str(tmp_path)).save(1, state)
        restored = JCheckpointer(str(tmp_path)).restore(1, jstate)
        got = [np.asarray(x) for x in jax.tree.leaves(restored)]
    want = jax.tree.leaves(host)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _trainer(tmp_path, name, **tkw):
    _, cfg = _cfgs(1)
    tcfg = base.TrainConfig(checkpoint_dir=str(tmp_path / name), **TCFG, **tkw)
    return Trainer(cfg, tcfg, base.ShapeConfig("t", SEQ, BATCH, "train"), device="cpu")


def test_trainer_restart_is_bitexact(tmp_path):
    straight = _trainer(tmp_path, "straight")
    hist = straight.run(4)
    first = _trainer(tmp_path, "restart")
    first.run(2)
    first.save(blocking=True)
    resumed = _trainer(tmp_path, "restart")
    assert resumed.step == 2
    hist_b = resumed.run(2)
    assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist[2:]]
    for a, b in zip(tree_leaves(resumed.state()), tree_leaves(straight.state())):
        assert torch.equal(a, b)


def test_trainer_threaded_checkpoints_and_gc(tmp_path):
    trainer = _trainer(tmp_path, "gc", checkpoint_every=1, keep_checkpoints=2)
    trainer.run(3)
    assert trainer.ckpt.all_steps() == [2, 3]
    restored = trainer.ckpt.restore(3, trainer.state())
    for a, b in zip(tree_leaves(restored), tree_leaves(trainer.state())):
        assert torch.equal(a, b)
    assert all(np.isfinite(h["step_time_s"]) for h in trainer.metrics_history)


@pytest.mark.parametrize("setting", [{"family": "rwkv"},
                                     {"attention_impl": "linformer"},
                                     {"grad_compression": "int8"}])
def test_trainer_rejects_unported_settings(tmp_path, setting):
    _, cfg = _cfgs(1)
    tkw = {k: v for k, v in setting.items() if k == "grad_compression"}
    cfg = dataclasses.replace(cfg, **{k: v for k, v in setting.items() if k not in tkw})
    tcfg = base.TrainConfig(checkpoint_dir=str(tmp_path), **tkw)
    with pytest.raises(NotImplementedError):
        Trainer(cfg, tcfg, base.ShapeConfig("t", SEQ, BATCH, "train"), device="cpu")


def test_trainer_refuses_cuda_without_a_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs(1)
    with pytest.raises(RuntimeError, match="no GPU"):
        Trainer(cfg, base.TrainConfig(checkpoint_dir=str(tmp_path)),
                base.ShapeConfig("t", SEQ, BATCH, "train"))


def test_params_to_numpy_round_trips():
    jcfg, _ = _cfgs(1)
    host = jax.tree.map(np.asarray, _jax_params(jcfg))
    back = params_to_numpy(params_from_numpy(host))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        np.testing.assert_array_equal(a, b)


def test_launcher_trains_on_cpu(tmp_path, capsys):
    hist = launch_train.main(["--reduced", "--device", "cpu", "--steps", "2",
                              "--batch", "2", "--seq", "80", "--profile",
                              "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "tokens/s" in out and "profile of steps 1..1" in out
    assert Checkpointer(str(tmp_path)).latest_step() == 2
    with pytest.raises(SystemExit):
        launch_train.main(["--reduced", "--device", "cpu", "--mesh", "prod"])
