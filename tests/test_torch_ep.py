"""Expert parallelism in the port (``models/moe.py:moe_forward_ep``, MoE
under a batch split, the Trainer's expert layout), on the CPU.

One group of 4 ``gloo`` ranks (``launch/mesh.py:spawn_local``) runs every
case on two ("data", "model") meshes over the same ranks, 4 x 1 (4 expert
ranks) and 2 x 2 (2 expert ranks, the capacity slots in 2 bands over
"model"); one JAX subprocess on 4 fake devices runs the reference beside
them, under meshes whose axes are ``AxisType.Auto`` (the reference's
``with_sharding_constraint`` raises under ``jax.make_mesh``'s default
explicit axes, R1). Weights and inputs are made once with numpy or the
port's ``init_params`` from a seed and handed to both.

* The reference test's MoE layer (``tests/test_perf_features.py:104``: 8
  experts top-2, d 16, moe_ff 32, 1 shared expert, x (8, 12, 16) x 0.5) at
  capacity 100 (no slot dropped) and 0.5 (slots dropped: the capacity is
  per source shard, so the oracle is the reference's ``moe_forward_ep``,
  not ``moe_forward``): the output, the aux loss and the gradients of
  sum(out²) + 3·aux with respect to x and every weight, against
  ``jax.grad`` of the same under the mesh, at the reference test's own
  bounds (2e-5 absolute on the output, 1e-4 on the gradients). A rank's
  loss counts its share of the aux, 3·aux / dp, as ``loss_fn`` does.
* Reduced DeepSeek-V2-Lite (MLA) and Kimi-K2 (GQA, ``spectral_shift_fused``:
  the port's plain K1-K4, the reference's CPU route) at 1 layer under
  ``moe_impl="ep"``: the loss and every gradient leaf of one grad step on
  the rank's slices of the expert layout (gathered), against ``jax.grad``
  of the reference's ``loss_fn`` under the same mesh, at 1e-4 of each
  leaf's max-abs.
* The Trainer: 3 steps under ``"ep"`` with ``capacity_factor = E / k``
  (no slot dropped on either route) against the port's single-device
  Trainer under ``"gspmd"`` (parameters at atol 2e-4, the reference's
  ``test_multidevice.py:65`` bound; losses at rel 1e-5); ``"gspmd"`` with
  the batch split at the config's own capacity against the single-device
  Trainer; the 4 x 1 checkpoint restored bitwise onto 2 x 2 and onto one
  device; the expert leaves and their moments split over "data", the
  rest whole; experts that do not tile the ranks fall back to
  ``moe_forward``; and the refusals that stay.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

AXES = ("data", "model")
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
CAPS = {"cap100": 100.0, "cap0.5": 0.5}
SEQ, BATCH, STEPS = 32, 4, 3
ARCHS = {"deepseek": ("deepseek-v2-lite-16b", {}),
         "kimi": ("kimi-k2-1t-a32b", {"attention_impl": "spectral_shift_fused"})}
LAYER_X = (8, 12, 16)
# checkpoint directories of the ranks' Trainers: EP 4 x 1 (saved, restored
# onto the others), EP 2 x 2, the gspmd batch split, refusals, fallback
CKPTS = ("ep41", "ep22", "gspmd", "refused", "fallback")


def _layer_cfg(capacity_factor: float):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(moe=True, num_experts=8, top_k=2, moe_d_ff=32, d_model=16,
                       num_shared_experts=1, capacity_factor=capacity_factor)


def _layer_inputs():
    """The MoE layer's weights (the port's ``init_params``, seed 0) and x."""
    from repro_torch.models.moe import moe_specs
    from repro_torch.models.params import init_params, params_to_numpy

    params = params_to_numpy(init_params(moe_specs(_layer_cfg(100.0)),
                                         torch.Generator().manual_seed(0), device="cpu"))
    x = (np.random.default_rng(1).normal(size=LAYER_X) * 0.5).astype(np.float32)
    return params, x


def _model_cfg(arch: str, **kw):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config

    name, extra = ARCHS[arch]
    return reduced(get_config(name), num_layers=1, moe_impl="ep", **dict(extra, **kw))


def _model_params(arch: str):
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params, params_to_numpy

    return params_to_numpy(init_params(model_specs(_model_cfg(arch)),
                                       torch.Generator().manual_seed(0), device="cpu"))


def _tokens() -> np.ndarray:
    from repro_torch.data.pipeline import SyntheticLM

    return SyntheticLM(512, SEQ, BATCH, seed=0).batch(0)["tokens"]


def _mesh(name, mesh41):
    from repro_torch.distributed.mesh import Mesh

    return mesh41 if name == "4x1" else Mesh(MESHES[name], AXES, device="cpu")


# --------------------------------------------------------------------------
# The ranks
# --------------------------------------------------------------------------
def _layer_case(mesh, cap: float) -> dict:
    """The MoE layer on the rank's rows under ``mesh``: output rows, aux,
    x's gradient rows and every weight's gradient summed over "data" (the
    rank's experts' rows of each expert leaf, its rows' share of the rest:
    the sum is the whole batch's gradient)."""
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.models.moe import moe_forward_ep
    from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map

    params, x = _layer_inputs()
    dp, d = mesh.shape["data"], mesh.coords["data"]
    rows = LAYER_X[0] // dp
    p = tree_map(lambda t: t.requires_grad_(True), params_from_numpy(params))
    xr = torch.from_numpy(x[d * rows:(d + 1) * rows]).requires_grad_(True)
    with sharding_rules(mesh):
        out, aux = moe_forward_ep(p, _layer_cfg(cap), xr)
        (torch.sum(out * out) + 3.0 * aux / dp).backward()
    return {"out": mesh.all_gather(out.detach(), ("data",)).numpy(), "aux": float(aux),
            "gx": mesh.all_gather(xr.grad, ("data",)).numpy(),
            "gw": [mesh.all_reduce(t.grad, "sum", ("data",)).numpy()
                   for t in tree_leaves(p)]}


def _model_case(mesh, arch: str) -> dict:
    """One grad step of the reduced model under ``"ep"`` on the rank's
    slices of the expert layout, its gradients gathered."""
    from repro_torch.data.pipeline import make_global_batch, to_device
    from repro_torch.distributed.sharding import param_layout, sharding_rules
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import gather_tree, params_from_numpy, shard_tree
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.train_step import make_grad_step

    cfg = _model_cfg(arch)
    layout = param_layout(mesh, cfg, model_specs(cfg))
    params = shard_tree(params_from_numpy(_model_params(arch)), layout.placements, mesh)
    batch = to_device(make_global_batch({"tokens": _tokens()}, mesh), "cpu")
    with sharding_rules(mesh, None, layout):
        loss, grads = make_grad_step(cfg)(params, batch)
    grads = gather_tree(grads, layout.placements, mesh)
    return {"loss": float(loss), "grads": [g.numpy() for g in tree_leaves(grads)]}


def _trainer(cfg, ckpt, mesh=None, every=0):
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.train.trainer import Trainer

    return Trainer(cfg, TrainConfig(checkpoint_dir=ckpt, seed=0, checkpoint_every=every,
                                    warmup_steps=1, total_steps=10),
                   ShapeConfig("t", SEQ, BATCH, "train"), mesh, device="cpu")


def _run(tr) -> dict:
    from repro_torch.models.params import tree_leaves

    losses = [h["loss"] for h in tr.run(STEPS, log_every=100)]
    return {"losses": losses,
            "params": [t.numpy().copy() for t in tree_leaves(tr.full_state()["params"])]}


def _dropless(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)


def _refusals(mesh, ckpt: str) -> dict:
    cfg = _model_cfg("deepseek")
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.train.trainer import Trainer

    cases = {"seq": {"seq": "model"}, "override": {"experts": "data"},
             "batch": {"batch": ("data", "model")}}
    out = {}
    for name, ov in cases.items():
        try:
            Trainer(cfg, TrainConfig(checkpoint_dir=ckpt), ShapeConfig("t", SEQ, BATCH, "train"),
                    mesh, rule_overrides=ov, device="cpu")
            out[name] = ""
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _fallback(mesh, ckpt: str) -> dict:
    """6 experts do not tile 4 expert ranks: ``moe_forward_ep`` is
    ``moe_forward`` there, and the Trainer keeps the experts whole."""
    from repro_torch.distributed.sharding import sharding_rules
    from repro_torch.models.moe import moe_forward, moe_forward_ep
    from repro_torch.models.params import params_from_numpy

    params, x = _layer_inputs()
    cfg = dataclasses.replace(_layer_cfg(1.25), num_experts=6)
    p = params_from_numpy(params)
    p = dict(p, router=p["router"][:, :6], **{k: p[k][:6] for k in ("w_gate", "w_up", "w_down")})
    rows = torch.from_numpy(x[2 * mesh.rank:2 * mesh.rank + 2])
    with sharding_rules(mesh):
        a, aux_a = moe_forward_ep(p, cfg, rows)
        b, aux_b = moe_forward(p, cfg, rows)
    tr = _trainer(dataclasses.replace(_model_cfg("deepseek"), num_experts=6), ckpt, mesh)
    return {"equal": bool(torch.equal(a, b)) and float(aux_a) == float(aux_b),
            "layout": tr.layout}


def _rank(mesh41, *ckpts: str) -> dict:
    from repro_torch.models.params import flatten_with_paths, tree_leaves

    dirs = dict(zip(CKPTS, ckpts))
    meshes = {name: _mesh(name, mesh41) for name in MESHES}
    res = {}
    for name, mesh in meshes.items():
        for tag, cap in CAPS.items():
            res[f"layer/{name}/{tag}"] = _layer_case(mesh, cap)
        for arch in ARCHS:
            res[f"model/{name}/{arch}"] = _model_case(mesh, arch)
    ds = _model_cfg("deepseek")
    ep41 = _trainer(_dropless(ds), dirs["ep41"], mesh41, every=STEPS)
    res["placements"] = {k: (pl.dims, pl.gather) for k, pl in
                         flatten_with_paths(ep41.layout.placements).items()}
    res["local"] = {k: tuple(t.shape) for k, t in flatten_with_paths(ep41.params).items()}
    res["moments"] = [tuple(t.shape) for t in tree_leaves(ep41.opt_state.m)]
    res["trainer/4x1"] = _run(ep41)
    res["trainer/2x2"] = _run(_trainer(_dropless(ds), dirs["ep22"], meshes["2x2"]))
    res["gspmd"] = _run(_trainer(dataclasses.replace(ds, moe_impl="gspmd"), dirs["gspmd"],
                                 meshes["2x2"]))
    onto = _trainer(_dropless(ds), dirs["ep41"], meshes["2x2"])
    res["restored_22"] = (onto.step, [t.numpy().copy() for t in
                                      tree_leaves(onto.full_state()["params"])])
    res["refused"] = _refusals(meshes["2x2"], dirs["refused"])
    res["fallback"] = _fallback(mesh41, dirs["fallback"])
    return res


# --------------------------------------------------------------------------
# The reference, on 4 fake JAX devices
# --------------------------------------------------------------------------
REF_SCRIPT = """
import pickle, jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
jax.config.update("jax_default_matmul_precision", "highest")
from repro.configs.base import ModelConfig, reduced
from repro.configs.registry import get_config
from repro.distributed.sharding import sharding_rules
from repro.models.model import loss_fn
from repro.models.moe import moe_forward_ep

with open({inp!r}, "rb") as f:
    inputs = pickle.load(f)
out = {{}}
for name, shape in {meshes!r}.items():
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    for tag, cap in {caps!r}.items():
        cfg = ModelConfig(moe=True, num_experts=8, top_k=2, moe_d_ff=32, d_model=16,
                          num_shared_experts=1, capacity_factor=cap)
        params = jax.tree.map(jnp.asarray, inputs["layer"][0])
        def loss(p, x):
            o, a = moe_forward_ep(p, cfg, x)
            return jnp.sum(o * o) + 3.0 * a, (o, a)
        with mesh, sharding_rules(mesh):
            (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(inputs["layer"][1]))
        out[f"layer/{{name}}/{{tag}}"] = dict(out=np.asarray(o), aux=float(a),
                                              gx=np.asarray(gx),
                                              gw=[np.asarray(g) for g in jax.tree.leaves(gp)])
    for arch, (cfg_name, extra) in {archs!r}.items():
        cfg = reduced(get_config(cfg_name), num_layers=1, moe_impl="ep", **extra)
        params = jax.tree.map(jnp.asarray, inputs["model"][arch])
        batch = {{"tokens": jnp.asarray(inputs["tokens"])}}
        with mesh, sharding_rules(mesh):
            (l, _), g = jax.jit(jax.value_and_grad(
                lambda p: loss_fn(p, cfg, batch), has_aux=True))(params)
        out[f"model/{{name}}/{{arch}}"] = dict(
            loss=float(l), grads=[np.asarray(x) for x in jax.tree.leaves(g)])
with open({outp!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference on 4 fake JAX devices, in a subprocess started here so
    that it runs while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("ep_ref")
    inp, outp = tmp / "inputs.pkl", tmp / "reference.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"layer": _layer_inputs(), "tokens": _tokens(),
                     "model": {arch: _model_params(arch) for arch in ARCHS}}, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    script = REF_SCRIPT.format(inp=str(inp), outp=str(outp), meshes=MESHES, caps=CAPS,
                               archs=ARCHS)
    proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield proc, outp
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, outp = reference_run
    out, err = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"reference subprocess failed (rc={proc.returncode})\n"
                             f"{out}\n{err[-4000:]}")
    with open(outp, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    return [str(tmp_path_factory.mktemp(name)) for name in CKPTS]


@pytest.fixture(scope="module")
def port(reference_run, ckpt_dirs):
    from repro_torch.launch.mesh import spawn_local

    return spawn_local(_rank, (4, 1), AXES, args=tuple(ckpt_dirs), device="cpu",
                       timeout_s=240)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The port's single-device Trainer under ``"gspmd"``: dropless, and at
    the config's own capacity."""
    cfg = dataclasses.replace(_model_cfg("deepseek"), moe_impl="gspmd")
    return {"dropless": _run(_trainer(_dropless(cfg), str(tmp_path_factory.mktemp("one")))),
            "own": _run(_trainer(cfg, str(tmp_path_factory.mktemp("one_own"))))}


def _rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_layer_matches_the_reference_ep(port, reference, mesh, cap):
    ref = reference[f"layer/{mesh}/{cap}"]
    for r in port:
        mine = r[f"layer/{mesh}/{cap}"]
        np.testing.assert_allclose(mine["out"], ref["out"], atol=2e-5, rtol=0)
        assert mine["aux"] == pytest.approx(ref["aux"], abs=1e-5)
        np.testing.assert_allclose(mine["gx"], ref["gx"], atol=1e-4, rtol=0)
        assert len(mine["gw"]) == len(ref["gw"]) == 7   # router, 3 experts, 3 shared
        for a, b in zip(mine["gw"], ref["gw"]):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_tight_capacity_drops_slots(port, reference):
    """At capacity 0.5 the per-shard capacity drops slots: the output
    differs from the dropless one, in both packages alike."""
    for mesh in MESHES:
        tight, free = (reference[f"layer/{mesh}/{c}"]["out"] for c in ("cap0.5", "cap100"))
        assert np.abs(tight - free).max() > 1e-2
        assert _rel(port[0][f"layer/{mesh}/cap0.5"]["out"], tight) < 1e-5


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_model_grads_match_the_reference_loss_fn(port, reference, mesh, arch):
    ref = reference[f"model/{mesh}/{arch}"]
    for r in port:
        mine = r[f"model/{mesh}/{arch}"]
        assert mine["loss"] == pytest.approx(ref["loss"], rel=1e-4)
        assert len(mine["grads"]) == len(ref["grads"])
        for a, b in zip(mine["grads"], ref["grads"]):
            assert _rel(a, b) <= 1e-4


def test_expert_leaves_split_over_data(port):
    """Under ``"ep"`` on 4 x 1 each rank holds 2 of the 8 experts of each
    expert leaf and of both its moments; every other leaf is whole."""
    places, local = port[0]["placements"], port[0]["local"]
    for path, (dims, gather) in places.items():
        assert gather == ()
        expert = path in ("layers::moe::w_gate", "layers::moe::w_up", "layers::moe::w_down")
        assert dims == (((), ("data",), (), ()) if expert else tuple(() for _ in dims)), path
    assert local["layers::moe::w_gate"] == (1, 2, 128, 64)
    assert local["layers::moe::shared::w_gate"] == (1, 128, 64)
    assert (1, 2, 64, 128) in port[0]["moments"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ep_trainer_matches_single_device(port, single, mesh):
    for r in port:
        mine = r[f"trainer/{mesh}"]
        np.testing.assert_allclose(mine["losses"], single["dropless"]["losses"], rtol=1e-5)
        assert len(mine["params"]) == len(single["dropless"]["params"])
        for a, b in zip(mine["params"], single["dropless"]["params"]):
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)


def test_gspmd_moe_with_the_batch_split_matches_single_device(port, single):
    for r in port:
        np.testing.assert_allclose(r["gspmd"]["losses"], single["own"]["losses"], rtol=1e-5)
        for a, b in zip(r["gspmd"]["params"], single["own"]["params"]):
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)


def test_checkpoint_restores_across_expert_layouts(port, ckpt_dirs):
    from repro_torch.models.params import tree_leaves

    saved = port[0]["trainer/4x1"]["params"]
    for r in port:
        step, params = r["restored_22"]
        assert step == STEPS
        for a, b in zip(params, saved):
            np.testing.assert_array_equal(a, b)
    cfg = dataclasses.replace(_dropless(_model_cfg("deepseek")), moe_impl="gspmd")
    one = _trainer(cfg, ckpt_dirs[0])
    assert one.step == STEPS and one.layout is None
    for a, b in zip(tree_leaves(one.params), saved):
        np.testing.assert_array_equal(a.numpy(), b)


def test_experts_that_do_not_tile_fall_back(port):
    for r in port:
        assert r["fallback"]["equal"]
        assert r["fallback"]["layout"] is None


@pytest.mark.parametrize("case,words", [("seq", "sequence shard"),
                                        ("override", "parameter sharding"),
                                        ("batch", "moe_impl 'ep' with the batch")])
def test_trainer_refuses_what_stays_refused(port, case, words):
    for r in port:
        assert words in r["refused"][case]
