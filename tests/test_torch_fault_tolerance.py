"""Fault tolerance in the port (``distributed/fault_tolerance.py``, the
Trainer's ``monitor=`` / ``injector=`` and its elastic restart,
``launch/train.py --fail-at``), on the CPU.

The four classes are held to the reference's
(``repro/distributed/fault_tolerance.py``, plain Python) on the same
inputs: ``ElasticPlan.plan`` over a grid of alive chips, model degree and
``max_data`` (the raising cases too), ``HeartbeatMonitor``'s beats,
``dead_hosts(now=)`` and ``stragglers()``, ``FailureInjector``.

The elastic run mirrors ``tests/test_multidevice.py:39`` (whose own run
fails under R1): one group of 4 ``gloo`` ranks trains reduced Qwen2-7B
(``num_landmarks=8``, ``spectral_shift_fused`` with the plain versions
here, ``remat="ss_stats"``) at seq 128, global batch 8, a checkpoint every
3 steps, on a 2 x 2 ("data", "model") mesh with a ``HeartbeatMonitor`` of
4 hosts (one rank each) and ``FailureInjector({6: ["host0"]})``, for 10
steps. ``ElasticPlan`` keeps TP 2 on the 3 surviving chips: world ranks 1
and 2 go on over {"data": 1, "model": 2} from the step-6 checkpoint, ranks
0 and 3 stop at step 6, inactive. The survivors' losses at steps 6-9
equal an uninterrupted 1 x 2 run over the same ranks restored from the
same checkpoint (1e-6); a control, the step-3 checkpoint's state restored
at step 6, must miss that bound. Every step's loss is held to the
single-device port Trainer's (rel 1e-4) and the final parameters to its
(atol 2e-4), PR 26's bounds. Then the straggler wiring
(``tests/test_trainer_engine.py:83``) and the launcher's ``--fail-at``
below 16 ranks, which raises the reference's ``ElasticPlan`` error.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SEQ, BATCH, STEPS, FAIL_AT, EVERY = 128, 8, 10, 6, 3
RESUME_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This process's Trainers on one thread, as each spawned rank runs:
    beside other test workers, more threads than cores slow them many
    times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config

    return reduced(get_config("qwen2-7b"), attention_impl="spectral_shift_fused",
                   attention_backend="interpret", remat="ss_stats", num_landmarks=8)


def _shape():
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig("train_4k", SEQ, BATCH, "train")


def _tcfg(directory: str):
    from repro_torch.configs.base import TrainConfig

    return TrainConfig(checkpoint_dir=directory, checkpoint_every=EVERY, total_steps=20)


# --------------------------------------------------------------------------
# The four classes against the reference's.
# --------------------------------------------------------------------------
def _plan(mod, alive, model, max_data):
    try:
        return mod.ElasticPlan.plan(alive, model, max_data)
    except RuntimeError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("model", [1, 2, 4, 8])
def test_elastic_plan_matches_reference(model):
    from repro.distributed import fault_tolerance as ref
    from repro_torch.distributed import fault_tolerance as port

    for alive in (0, 1, 2, 3, 5, 7, 8, 15, 16, 31, 256):
        for max_data in (1, 2, 3, 16):
            a, b = _plan(port, alive, model, max_data), _plan(ref, alive, model, max_data)
            if isinstance(b, tuple):
                assert a == b
            else:
                assert (a.data, a.model, a.dropped_chips) == (b.data, b.model,
                                                              b.dropped_chips)


@pytest.mark.parametrize("factor,ewma", [(2.0, 0.9), (1.5, 0.5)])
def test_heartbeat_monitor_matches_reference(factor, ewma):
    from repro.distributed import fault_tolerance as ref
    from repro_torch.distributed import fault_tolerance as port

    hosts = [f"h{i}" for i in range(5)]
    rng = np.random.default_rng(0)
    mons = [m.HeartbeatMonitor(hosts, timeout_s=10.0, straggler_factor=factor, ewma=ewma)
            for m in (port, ref)]
    for t in range(12):
        for i, h in enumerate(hosts):
            if i == 4 and t > 3:
                continue   # h4 stops beating
            dt = float(rng.uniform(0.5, 1.5)) * (4.0 if i == 2 and t > 6 else 1.0)
            for m in mons:
                m.beat(h, dt, now=float(t))
        for m in mons:
            assert [s.step_time_ewma for s in m.hosts.values()] == \
                [s.step_time_ewma for s in mons[1].hosts.values()]
        for now in (float(t), t + 9.5, t + 15.0):
            assert mons[0].dead_hosts(now=now) == mons[1].dead_hosts(now=now)
        assert mons[0].stragglers() == mons[1].stragglers()
    assert mons[0].dead_hosts(now=15.0) == ["h4"]
    assert port.HeartbeatMonitor(hosts).stragglers() == []


def test_failure_injector_matches_reference():
    from repro.distributed import fault_tolerance as ref
    from repro_torch.distributed import fault_tolerance as port

    schedule = {2: ["host0"], 5: ["host1", "host3"]}
    a, b = port.FailureInjector(schedule), ref.FailureInjector(schedule)
    assert [a.failures_at(s) for s in range(8)] == [b.failures_at(s) for s in range(8)]


# --------------------------------------------------------------------------
# The elastic run on 4 gloo ranks.
# --------------------------------------------------------------------------
def _copy_step(src: str, step: int, dst: str, as_step: int) -> None:
    shutil.copytree(os.path.join(src, f"step_{step:08d}"),
                    os.path.join(dst, f"step_{as_step:08d}"))


def _elastic_rank(mesh, root: str) -> dict:
    import torch.distributed as dist

    from repro_torch.distributed.fault_tolerance import FailureInjector, HeartbeatMonitor
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models.params import params_to_numpy
    from repro_torch.train.trainer import Trainer

    cfg, shape = _cfg(), _shape()
    elastic = os.path.join(root, "elastic")
    monitor = HeartbeatMonitor([f"host{i}" for i in range(4)], timeout_s=600)
    tr = Trainer(cfg, _tcfg(elastic), shape, mesh, device="cpu", monitor=monitor,
                 injector=FailureInjector({FAIL_AT: ["host0"]}))
    hist = tr.run(STEPS)
    out = {"losses": {h["step"]: h["loss"] for h in hist}, "active": tr.active,
           "step": tr.step, "mesh": dict(tr.mesh.shape), "hosts": list(monitor.hosts),
           "recoveries": tr.recoveries}
    if tr.active:
        out["params"] = params_to_numpy(tr.full_state(device="cpu")["params"])
    if mesh.rank == 1:   # the new mesh's rank 0: its last save is done (run waits)
        for name, step in (("resume", FAIL_AT), ("control", EVERY)):
            os.makedirs(os.path.join(root, name))
            _copy_step(elastic, step, os.path.join(root, name), FAIL_AT)
    dist.barrier()
    # uninterrupted runs over the survivors' 1 x 2 sub-mesh, from the
    # step-6 checkpoint and (the control) from step 3's state at step 6
    sub = Mesh((1, 2), ("data", "model"), ranks=[1, 2], device="cpu")
    if sub.member:
        for name in ("resume", "control"):
            t = Trainer(cfg, _tcfg(os.path.join(root, name)), shape, sub, device="cpu")
            assert t.step == FAIL_AT
            out[name] = {h["step"]: h["loss"] for h in t.run(STEPS - FAIL_AT)}
    sub.close()
    return out


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_local

    root = str(tmp_path_factory.mktemp("elastic"))
    return spawn_local(_elastic_rank, (2, 2), ("data", "model"), args=(root,),
                       device="cpu", timeout_s=120.0)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    from repro_torch.models.params import params_to_numpy
    from repro_torch.train.trainer import Trainer

    tr = Trainer(_cfg(), _tcfg(str(tmp_path_factory.mktemp("one"))), _shape(),
                 device="cpu")
    hist = tr.run(STEPS)
    return [h["loss"] for h in hist], params_to_numpy(tr.params)


def test_elastic_restart_replans_onto_the_survivors(elastic):
    for rank, r in enumerate(elastic):
        assert r["hosts"] == ["host1", "host2", "host3"]
        assert r["mesh"] == {"data": 1, "model": 2}
        assert all(abs(x) < 100 for x in r["losses"].values())
        (rec,) = r["recoveries"]
        assert rec["ranks"] == [1, 2] and rec["member"] == (rank in (1, 2))
        if rank in (1, 2):
            assert r["active"] and r["step"] == STEPS
            assert sorted(r["losses"]) == list(range(STEPS))
            assert rec["step"] == FAIL_AT and rec["restore_s"] >= 0
        else:
            assert not r["active"] and r["step"] == FAIL_AT
            assert sorted(r["losses"]) == list(range(FAIL_AT))


def test_elastic_restart_equals_an_uninterrupted_restore(elastic):
    for r in elastic[1:3]:
        for step in range(FAIL_AT, STEPS):
            assert abs(r["losses"][step] - r["resume"][step]) <= RESUME_TOL, step
        # the control (step 3's state at step 6) must miss the bound
        worst = max(abs(r["losses"][s] - r["control"][s]) for s in range(FAIL_AT, STEPS))
        assert worst > RESUME_TOL, worst


def test_elastic_restart_matches_the_single_device_trainer(elastic, single):
    losses, params = single
    for r in elastic:
        for step, loss in r["losses"].items():
            assert abs(loss - losses[step]) <= 1e-4 * max(1.0, abs(losses[step])), step
    from repro_torch.models.params import flatten_with_paths

    want = flatten_with_paths(params)
    for r in elastic[1:3]:
        got = flatten_with_paths(r["params"])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=2e-4, err_msg=k)


# --------------------------------------------------------------------------
# Stragglers and the launcher.
# --------------------------------------------------------------------------
def test_trainer_beats_every_host_and_flags_a_straggler(tmp_path):
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
    from repro_torch.train.trainer import Trainer

    mon = HeartbeatMonitor([f"h{i}" for i in range(4)])
    tr = Trainer(_cfg(), TrainConfig(checkpoint_dir=str(tmp_path)),
                 ShapeConfig("train_4k", 64, 4, "train"), device="cpu", monitor=mon)
    hist = tr.run(2, log_every=1000)
    ewma = hist[0]["step_time_s"]
    ewma = mon.ewma * ewma + (1 - mon.ewma) * hist[1]["step_time_s"]
    assert [s.step_time_ewma for s in mon.hosts.values()] == [ewma] * 4
    for _ in range(20):
        mon.beat("h3", 50.0)
    assert mon.stragglers() == ["h3"]


def test_default_monitor_has_one_host_without_a_mesh(tmp_path):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import Trainer

    tr = Trainer(_cfg(), TrainConfig(checkpoint_dir=str(tmp_path)), _shape(), device="cpu")
    assert list(tr.monitor.hosts) == ["host0"] and tr.monitor.timeout_s == 600.0


def test_fail_at_below_16_ranks_raises_the_reference_error(tmp_path):
    from repro.distributed.fault_tolerance import ElasticPlan
    from repro_torch.launch import train

    with pytest.raises(RuntimeError) as want:
        ElasticPlan.plan(0, 1, 2)   # one host of 2 ranks, failed: no chip left
    with pytest.raises(RuntimeError, match=str(want.value)):
        train.main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                    "--seq", "64", "--nproc", "2", "--fail-at", "1"])
