"""Data- and sequence-parallel training in the port, on the CPU.

One group of 4 ``gloo`` ranks on a ("data", "model") mesh of 2 x 2
(``launch/mesh.py:spawn_local``, a time limit on every collective) runs the
port's ``Trainer`` on reduced Qwen2-7B (``num_landmarks=8``, seq 64, global
batch 4, ``attention_impl="spectral_shift_fused"`` with the reference's
``attention_backend="interpret"``, the plain versions here, and
``remat="ss_stats"``), as the reference's ``test_sharded_attn.py:179``:

* ``{"seq": "model"}``: batch rows over "data", the sequence over "model"
  (32 positions a rank), attention through the context-parallel attention.
  After 2 steps its parameters against the port's single-device
  ``Trainer`` (atol 2e-4, the reference test's bound; measured 1.2e-7),
  its losses against ``jax.jit(repro.train.train_step.make_train_step)``
  on one device from the same initial weights and batches (rel 1e-4;
  measured 2.2e-7);
* no override: data-parallel over "data" under the default rules, whose
  parameter entries now apply (FSDP over "data", tensor parallelism over
  "model"), held the same way;
* checkpoints: rank 0 writes, a second Trainer on every rank restores the
  same step and parameters; gathered parameters identical on every rank;
* ``make_global_batch``: every rank's rows, sequence slice and targets
  reassemble the global batch and its next-token targets; ``make_local_mesh``
  lays the ranks out row-major, as ``spawn_local``'s mesh;
* refused: a parameter-sharding override; under a sequence shard Hymba
  and Whisper under an approximate plain impl, LLaVA and the dense family
  under the jnp backend, MoE; ``grad_compression``; a mesh left
  at its default device ("cuda") without a GPU, and a Trainer whose
  ``device`` is not its mesh's.

Then ``python -m repro_torch.launch.train --nproc 2 --mesh 1x2 --seq-axis
model`` on the CPU, its losses against the single-device launcher's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SEQ, BATCH, STEPS = 64, 4, 2
MESH = (2, 2)
AXES = ("data", "model")


def _cfg():
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config

    return reduced(get_config("qwen2-7b"), attention_impl="spectral_shift_fused",
                   attention_backend="interpret", remat="ss_stats", num_landmarks=8)


def _shape():
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig("train_4k", SEQ, BATCH, "train")


def _params(tr) -> list:
    """The whole parameters (``Trainer.full_state``: gathered under a
    parameter layout; a collective that every rank calls)."""
    from repro_torch.models.params import tree_leaves

    return [t.detach().numpy().copy() for t in tree_leaves(tr.full_state()["params"])]


def _refusals(mesh, ckpt: str) -> dict:
    from repro_torch.configs.base import TrainConfig, reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.train.trainer import Trainer

    cfg, shape = _cfg(), _shape()
    cases = {
        "param_rule": (cfg, TrainConfig(checkpoint_dir=ckpt),
                       {"seq": "model", "heads": "model"}),
        # Hymba trains sequence-parallel, but not under an approximate
        # plain route, which would attend over the rank's own rows only
        "hybrid": (reduced(get_config("hymba-1.5b"), attention_impl="nystrom"),
                   TrainConfig(checkpoint_dir=ckpt), {"seq": "model"}),
        # Whisper and LLaVA train sequence-parallel, but not under an
        # approximate plain route or the jnp backend
        "audio": (reduced(get_config("whisper-base"), attention_impl="nystrom"),
                  TrainConfig(checkpoint_dir=ckpt), {"seq": "model"}),
        "vlm": (reduced(get_config("llava-next-34b"), attention_impl="spectral_shift_fused",
                        attention_backend="jnp"),
                TrainConfig(checkpoint_dir=ckpt), {"seq": "model"}),
        "moe": (reduced(get_config("deepseek-v2-lite-16b")), TrainConfig(checkpoint_dir=ckpt),
                {"seq": "model"}),
        "jnp": (dataclasses.replace(cfg, attention_backend="jnp"),
                TrainConfig(checkpoint_dir=ckpt), {"seq": "model"}),
        "compression": (cfg, TrainConfig(checkpoint_dir=ckpt, grad_compression="int8"),
                        {"seq": "model"}),
    }
    out = {}
    for name, (c, tcfg, ov) in cases.items():
        try:
            Trainer(c, tcfg, shape, mesh, rule_overrides=ov, device="cpu")
            out[name] = ""
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _rank(mesh, ckpt_sp: str, ckpt_dp: str, ckpt_refused: str) -> dict:
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM, make_global_batch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.trainer import Trainer

    cfg, shape = _cfg(), _shape()
    res = {}
    tr = Trainer(cfg, TrainConfig(checkpoint_dir=ckpt_sp, seed=0, checkpoint_every=STEPS),
                 shape, mesh, rule_overrides={"seq": "model"}, device="cpu")
    res["sp_cfg"] = (tr.cfg.attention_backend, tr.cfg.remat, tr.cfg.landmark_via_matmul)
    res["sp_losses"] = [h["loss"] for h in tr.run(STEPS, log_every=100)]
    res["sp_params"] = _params(tr)
    again = Trainer(cfg, TrainConfig(checkpoint_dir=ckpt_sp, seed=0), shape, mesh,
                    rule_overrides={"seq": "model"}, device="cpu")
    res["restored"] = (again.step, all(np.array_equal(a, b) for a, b in
                                       zip(_params(again), res["sp_params"])))
    dp = Trainer(cfg, TrainConfig(checkpoint_dir=ckpt_dp, seed=0, checkpoint_every=0),
                 shape, mesh, device="cpu")
    res["dp_losses"] = [h["loss"] for h in dp.run(STEPS, log_every=100)]
    res["dp_params"] = _params(dp)
    host = SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0).batch(0)
    res["batch"] = make_global_batch(host, mesh, {"seq": "model"})
    res["refused"] = _refusals(mesh, ckpt_refused)
    local = make_local_mesh(2, device="cpu")
    res["local_mesh"] = (local.shape, local.coords == mesh.coords,
                         local.index(("data", "model")) == mesh.rank)
    local_id = local.mesh_id
    del local
    res["devices"] = _device_rules(mesh, cfg, shape, ckpt_refused, local_id)
    return res


def _device_rules(mesh, cfg, shape, ckpt: str, collected: int) -> dict:
    """A mesh runs on the card unless asked for the CPU, and the Trainer
    refuses a device its mesh does not run on; a collected mesh leaves the
    custom ops' registry (``collected``: the id of one no longer held)."""
    import gc

    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed.mesh import mesh_by_id
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.trainer import Trainer

    out = {}
    for name, make in (("mesh", lambda: make_local_mesh(2)),
                       ("trainer", lambda: Trainer(cfg, TrainConfig(checkpoint_dir=ckpt),
                                                   shape, mesh))):
        try:
            make()
            out[name] = ""
        except (RuntimeError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    gc.collect()
    try:
        mesh_by_id(collected)
        out["dropped"] = False
    except KeyError:
        out["dropped"] = True
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_local

    dirs = [str(tmp_path_factory.mktemp(name)) for name in ("sp", "dp", "refused")]
    return spawn_local(_rank, MESH, AXES, args=tuple(dirs), device="cpu", timeout_s=240)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The port's single-device Trainer on the same config: initial and
    final parameters, losses."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.params import params_to_numpy
    from repro_torch.train.trainer import Trainer

    tr = Trainer(_cfg(), TrainConfig(checkpoint_dir=str(tmp_path_factory.mktemp("one")),
                                     seed=0, checkpoint_every=0),
                 _shape(), device="cpu")
    init = params_to_numpy(tr.params)
    losses = [h["loss"] for h in tr.run(STEPS, log_every=100)]
    return {"init": init, "losses": losses, "params": _params(tr)}


def test_sp_trainer_keeps_the_fused_route(port):
    for r in port:
        assert r["sp_cfg"] == ("interpret", "ss_stats", True)


def test_sp_trainer_matches_single_device(port, single):
    for a, b in zip(port[0]["sp_params"], single["params"]):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
    np.testing.assert_allclose(port[0]["sp_losses"], single["losses"], rtol=1e-5)


def test_sp_trainer_matches_jax_losses(port, single):
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.configs.registry import get_config as jget_config
    from repro.data import pipeline as jpipeline
    from repro.optim import adamw as jadamw
    from repro.optim import schedules as jschedules
    from repro.train import train_step as jtrain_step

    jcfg = jbase.reduced(jget_config("qwen2-7b"), attention_impl="spectral_shift_fused",
                         attention_backend="interpret", remat="ss_stats", num_landmarks=8)
    jt = jbase.TrainConfig(seed=0)
    lr_fn = jschedules.warmup_cosine(jt.learning_rate, jt.warmup_steps, jt.total_steps)
    params = jax.tree.map(jnp.asarray, single["init"])
    step = jax.jit(jtrain_step.make_train_step(jcfg, jt, lr_fn))
    opt = jadamw.adamw_init(params)
    data = jpipeline.SyntheticLM(jcfg.vocab_size, SEQ, BATCH, seed=0)
    ref = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, {"tokens": jnp.asarray(data.batch(i)["tokens"])})
        ref.append(float(m["loss"]))
    np.testing.assert_allclose(port[0]["sp_losses"], ref, rtol=1e-4)


def test_data_parallel_matches_single_device(port, single):
    for a, b in zip(port[0]["dp_params"], single["params"]):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
    np.testing.assert_allclose(port[0]["dp_losses"], single["losses"], rtol=1e-5)


def test_ranks_stay_identical_and_restore(port):
    for r in port[1:]:
        for a, b in zip(r["sp_params"], port[0]["sp_params"]):
            np.testing.assert_array_equal(a, b)
        assert r["sp_losses"] == port[0]["sp_losses"]
    assert all(r["restored"] == (STEPS, True) for r in port)


def test_local_mesh_lays_ranks_out_row_major(port):
    # make_local_mesh(2) over the same 4 ranks: (data 2, model 2), rank =
    # data * 2 + model, as spawn_local's mesh
    for r in port:
        assert r["local_mesh"] == ({"data": 2, "model": 2}, True, True)


def test_mesh_and_trainer_default_to_the_card(port):
    # no GPU here: a mesh asked for nothing raises, and a Trainer given a
    # CPU mesh with its default device="cuda" refuses instead of training
    # on the CPU
    for r in port:
        assert r["devices"]["mesh"].startswith("RuntimeError") and "cpu" in r["devices"]["mesh"]
        assert r["devices"]["trainer"].startswith("ValueError")
        assert r["devices"]["dropped"]


def test_global_batch_rows_and_slices(port):
    from repro_torch.data.pipeline import SyntheticLM

    tokens = SyntheticLM(_cfg().vocab_size, SEQ, BATCH, seed=0).batch(0)["tokens"]
    # rank = data * 2 + model: rows by "data", the sequence by "model"
    rows = [np.concatenate([port[2 * d + m]["batch"]["tokens"] for m in range(2)], 1)
            for d in range(2)]
    np.testing.assert_array_equal(np.concatenate(rows, 0), tokens)
    targets = np.concatenate(
        [np.concatenate([port[2 * d + m]["batch"]["targets"] for m in range(2)], 1)
         for d in range(2)], 0)
    np.testing.assert_array_equal(targets[:, :-1], tokens[:, 1:])
    assert np.all(targets[:, -1] == 0)


@pytest.mark.parametrize("case,words", [("param_rule", "parameter sharding"),
                                        ("hybrid", "sequence shard"),
                                        ("jnp", "sequence shard"),
                                        ("compression", "grad_compression"),
                                        ("audio", "attention 'nystrom' / backend 'auto' "
                                                  "under a sequence shard"),
                                        ("vlm", "attention 'spectral_shift_fused' / backend "
                                                "'jnp' under a sequence shard"),
                                        ("moe", "(MoE, moe_impl 'gspmd') under a sequence")])
def test_trainer_refuses_what_waits(port, case, words):
    for r in port:
        assert words in r["refused"][case]


def test_launcher_spawns_a_sequence_parallel_mesh(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    common = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "64",
              "--attention", "spectral_shift_fused"]
    one = launch_train.main(common)
    mesh = launch_train.main(common + ["--nproc", "2", "--mesh", "1x2", "--seq-axis",
                                       "model", "--metrics-out", str(tmp_path / "m.json")])
    np.testing.assert_allclose([h["loss"] for h in mesh], [h["loss"] for h in one],
                               rtol=1e-5)
    out = capsys.readouterr().out
    assert "2 ranks" in out and "collectives:" in out
    assert (tmp_path / "m.json").exists()
