"""The port's context-parallel attention (``repro_torch/kernels/sharded.py``)
against the reference's, on the CPU.

One group of 2 ``gloo`` ranks (``launch/mesh.py:spawn_local``, a time limit
on every collective) runs every port-side case while one subprocess with
2 fake JAX devices runs the reference's ``ss_attention_fused_sharded`` in
interpret mode (``tests/test_sharded_attn.py``'s mechanism), both on the
same numpy inputs (seed 0), b = 2, d = 32, c = 16.

Oracles and bounds (the reference test's own metric, max |a - b| /
max(|b|, 1e-3) elementwise, and its bounds):

* n = 128 and 256, causal and bidirectional: the port's sharded attention against
  the reference's, forward rel 1e-3, gradients of sum(out * w)
  rel 1e-2 (measured: forward <= 5.9e-4, gradients <= 4.7e-4);
* ragged n = 251 over 2 ranks (126 rows a rank, one padded): against the
  reference's single-device ``ss_attention_fused``, whose sharded route
  raises at ragged lengths on this tree (ROADMAP R1), same bounds
  (measured: forward 3.1e-4, gradients 3.9e-4);
* ``remat="ss_stats"``'s policy under the sequence shard against no remat:
  gradients within 1e-5 (measured: bit-equal), and the policy keeps the
  B-side op (``repro_torch::landmark_summary_sp``): its two collectives
  are not rerun, counted on the mesh;
* ``apply_seq_sharding_config``, ``active_seq_sharding``, ``make_key`` /
  ``heuristic_plan`` / ``PlanKey.decode`` against the reference's answers
  (``test_sharded_attn.py:126``), with the two named differences
  (ROADMAP): the CPU heuristic keeps ``remat="ss_stats"`` where the
  reference widens it to "full", and the sharded heuristic's tiling is 0
  (the kernels' own plans) where the reference's is a block size;
* ``compress`` bit-equal to the reference's on one numpy input, and the
  2-rank compressed all-reduce within ``test_multidevice.py:94``'s bound.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import types
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

N_CASES = [(128, False), (128, True), (256, False), (256, True)]
RAGGED = (251, True)
B, D, C = 2, 32, 16
AX = ("data",)
FWD_TOL, GRAD_TOL = 1e-3, 1e-2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-3)))


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for n, _ in N_CASES + [RAGGED]:
        for name, s in (("q", 0.5), ("k", 0.5), ("v", 1.0), ("w", 1.0)):
            out[f"{name}{n}"] = (rng.standard_normal((B, n, D)) * s).astype(np.float32)
    out["comp"] = rng.standard_normal(64).astype(np.float32)
    return out


# --------------------------------------------------------------------------
# The port's side: one function per rank of the spawned group.
# --------------------------------------------------------------------------
def _sharded_grads(mesh, cfg, q, k, v, w, n, loss="dot", context_fn=None):
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.sharded import (gather_sequence, shard_sequence,
                                             ss_attention_fused_sharded)

    ql, kl, vl = (shard_sequence(torch.from_numpy(x), mesh, AX).requires_grad_(True)
                  for x in (q, k, v))
    wl = shard_sequence(torch.from_numpy(w), mesh, AX)

    def f(a, b, c_):
        out = ss_attention_fused_sharded(a, b, c_, cfg, mesh=mesh, seq_axes=AX, seq_len=n)
        return out, ((out * wl).sum() if loss == "dot" else (out ** 2).sum())

    calls = mesh.collective_calls
    if context_fn is None:
        out, val = f(ql, kl, vl)
    else:
        out, val = checkpoint(f, ql, kl, vl, use_reentrant=False, context_fn=context_fn)
    grads = torch.autograd.grad(val, (ql, kl, vl))
    calls = mesh.collective_calls - calls
    gathered = [gather_sequence(t.detach(), mesh, AX, n).numpy() for t in (out, *grads)]
    return gathered, calls


def _config_answers(mesh) -> dict:
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import (active_seq_sharding,
                                                  apply_seq_sharding_config,
                                                  sharding_rules)
    from repro_torch.kernels import dispatch

    cfg = reduced(get_config("qwen2-7b"), attention_impl="spectral_shift_fused",
                  attention_backend="auto", remat="ss_stats")
    ov = {"seq": "data"}
    out = {}
    for name, c in (("auto", cfg),
                    ("interpret", dataclasses.replace(cfg, attention_backend="interpret")),
                    ("legacy", dataclasses.replace(cfg, seq_shard_fused=False))):
        r = apply_seq_sharding_config(c, mesh, ov)
        out[name] = (r.attention_backend, r.remat, r.landmark_via_matmul)
    out["unsharded"] = apply_seq_sharding_config(cfg, mesh, {}) is cfg
    with sharding_rules(mesh, ov):
        _, seq_axes, lead_axes = active_seq_sharding()
    out["active"] = (seq_axes, lead_axes)
    out["outside"] = active_seq_sharding()
    key = dispatch.make_key(4096, 64, 64, "bfloat16", True, backend="tpu", seq_shards=4)
    plan = dispatch.heuristic_plan(key)
    out["key"] = (key.encode(), dispatch.PlanKey.decode(key.encode()) == key,
                  plan.impl, plan.block_n)
    cuda_key = dispatch.make_key(8192, 64, 128, "bfloat16", True, backend="cuda",
                                 seq_shards=2)
    out["cuda_sweep"] = dispatch.get_plan(cuda_key, autotune_enabled=True).impl
    return out


def _global_batch(mesh) -> dict:
    from repro_torch.data.pipeline import SyntheticLM, make_global_batch

    host = SyntheticLM(vocab_size=100, seq_len=16, global_batch=2, seed=3).batch(1)
    return make_global_batch(host, mesh, {"seq": "data"})


def _recompute_all(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.PREFER_RECOMPUTE


def _rank(mesh, inputs: dict) -> dict:
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    from repro_torch.core.attention import SSConfig
    from repro_torch.models.model import _ss_stats_policy
    from repro_torch.optim.compression import make_compressed_grad_allreduce

    res = {}
    for n, causal in N_CASES + [RAGGED]:
        cfg = SSConfig(num_landmarks=C, causal=causal, landmark_via_matmul=True)
        (out, *grads), calls = _sharded_grads(
            mesh, cfg, *(inputs[f"{x}{n}"] for x in "qkvw"), n)
        res[(n, causal)] = (out, grads, calls)
    cfg = SSConfig(num_landmarks=C, causal=True, landmark_via_matmul=True)
    q, k, v, w = (inputs[f"{x}256"] for x in "qkvw")
    ss = partial(create_selective_checkpoint_contexts, _ss_stats_policy)
    res["remat"] = {name: _sharded_grads(mesh, cfg, q, k, v, w, 256, loss="square",
                                         context_fn=fn)
                    for name, fn in (("none", None), ("ss_stats", ss),
                                     ("full", partial(create_selective_checkpoint_contexts,
                                                      _recompute_all)))}
    res["config"] = _config_answers(mesh)
    res["batch"] = _global_batch(mesh)
    g = {"w": torch.from_numpy(inputs["comp"])}
    red, new_res = make_compressed_grad_allreduce(mesh, "data")(
        g, {"w": torch.zeros(64)})
    res["compressed"] = (red["w"].numpy(), new_res["w"].numpy())
    return res


# --------------------------------------------------------------------------
# Fixtures: the port's group and the reference's subprocess.
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def inputs_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "inputs.npz"
    np.savez(path, **_inputs())
    return path


@pytest.fixture(scope="module")
def port(inputs_file, reference_run):
    from repro_torch.launch.mesh import spawn_local

    inputs = dict(np.load(inputs_file))
    return spawn_local(_rank, (2,), AX, args=(inputs,), device="cpu", timeout_s=180)


REF_SCRIPT = """
import numpy as np, jax, jax.numpy as jnp
from repro.core.attention import SSConfig
from repro.kernels.ops import ss_attention_fused
from repro.kernels.sharded import ss_attention_fused_sharded
mesh = jax.make_mesh((2,), ("data",))
inp = np.load({inp!r})
out = {{}}
for n, causal, sharded in {cases!r}:
    q, k, v, w = (jnp.asarray(inp[f"{{x}}{{n}}"]) for x in "qkvw")
    cfg = SSConfig(num_landmarks={c}, causal=causal, landmark_via_matmul=True)
    if sharded:
        f = lambda q, k, v: ss_attention_fused_sharded(
            q, k, v, cfg, mesh=mesh, seq_axes=("data",), interpret=True)
    else:
        f = lambda q, k, v: ss_attention_fused(q, k, v, cfg, interpret=True)
    o, vjp = jax.vjp(jax.jit(f), q, k, v)
    grads = vjp(w)
    tag = f"{{n}}_{{int(causal)}}"
    out["out_" + tag] = np.asarray(o)
    for name, g in zip("qkv", grads):
        out[f"d{{name}}_" + tag] = np.asarray(g)
np.savez({outp!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference_run(inputs_file, tmp_path_factory):
    """The reference's subprocess on 2 fake devices (``conftest.
    run_subprocess``'s environment), started here so that it runs while
    the port's ranks do; ``reference`` reads its output."""
    outp = tmp_path_factory.mktemp("sharded_ref") / "ref.npz"
    cases = [(n, causal, True) for n, causal in N_CASES] + [(*RAGGED, False)]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT.format(inp=str(inputs_file), outp=str(outp),
                                                 cases=cases, c=C)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
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
    return dict(np.load(outp))


# --------------------------------------------------------------------------
# Tests.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,causal", N_CASES + [RAGGED])
def test_forward_matches_reference(port, reference, n, causal):
    out, _, _ = port[0][(n, causal)]
    assert out.shape == (B, n, D)
    assert _rel(out, reference[f"out_{n}_{int(causal)}"]) <= FWD_TOL
    # every rank gathered the same global output
    np.testing.assert_array_equal(out, port[1][(n, causal)][0])


@pytest.mark.parametrize("n,causal", N_CASES + [RAGGED])
def test_gradients_match_reference(port, reference, n, causal):
    _, grads, _ = port[0][(n, causal)]
    for name, g in zip("qkv", grads):
        assert _rel(g, reference[f"d{name}_{n}_{int(causal)}"]) <= GRAD_TOL, name


def test_collectives_are_landmark_sized_and_counted(port):
    # forward: the landmark sums (1), the B-side's max and sum (2); backward:
    # the B-side cotangent (1), the landmark cotangents (1)
    for n, causal in N_CASES + [RAGGED]:
        assert port[0][(n, causal)][2] == 5


def test_ss_stats_policy_keeps_the_sharded_b_side(port):
    remat = port[0]["remat"]
    (ref, ref_calls) = remat["none"]
    for name in ("ss_stats", "full"):
        grads, _ = remat[name]
        for a, b in zip(grads, ref):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    # the recompute reruns the landmark all-reduce only under ss_stats (the
    # B-side op is saved), all three collectives under a recompute-everything
    # policy
    assert remat["ss_stats"][1] == ref_calls + 1
    assert remat["full"][1] == ref_calls + 3


def _fake_jax_mesh():
    return types.SimpleNamespace(axis_names=("data",), shape={"data": 2})


def test_seq_sharding_config_matches_reference(port):
    from repro.configs.base import reduced as jreduced
    from repro.configs.registry import get_config as jget_config
    from repro.distributed import sharding as jsharding

    jcfg = jreduced(jget_config("qwen2-7b"), attention_impl="spectral_shift_fused",
                    attention_backend="auto", remat="ss_stats")
    mesh = _fake_jax_mesh()
    ov = {"seq": "data"}
    ref = {}
    for name, c in (("auto", jcfg),
                    ("interpret", dataclasses.replace(jcfg, attention_backend="interpret")),
                    ("legacy", dataclasses.replace(jcfg, seq_shard_fused=False))):
        r = jsharding.apply_seq_sharding_config(c, mesh, ov)
        ref[name] = (r.attention_backend, r.remat, r.landmark_via_matmul)
    with jsharding.sharding_rules(mesh, ov):
        _, seq_axes, lead_axes = jsharding.active_seq_sharding()
    got = port[0]["config"]
    assert got["interpret"] == ref["interpret"] == ("interpret", "ss_stats", True)
    assert got["legacy"] == ref["legacy"] == ("jnp", "full", True)
    # named difference: the port's CPU route keeps the saved B-side op
    assert ref["auto"] == ("auto", "full", True)
    assert got["auto"] == ("auto", "ss_stats", True)
    assert got["unsharded"]
    assert got["active"] == (tuple(seq_axes), tuple(lead_axes))
    assert got["active"][0] == ("data",) and "data" not in got["active"][1]
    assert got["outside"] == (None, (), ())


def test_sharded_dispatch_key_matches_reference(port):
    from repro.kernels import dispatch as jdispatch

    jkey = jdispatch.make_key(4096, 64, 64, "bfloat16", True, backend="tpu",
                              seq_shards=4)
    jplan = jdispatch.heuristic_plan(jkey)
    encoded, round_trip, impl, block_n = port[0]["config"]["key"]
    assert encoded == jkey.encode()
    assert round_trip and jdispatch.PlanKey.decode(encoded) == jkey
    assert impl == jplan.impl == "sharded"
    assert block_n == 0 < jplan.block_n   # named difference: the kernels' own plans
    # a sharded key never sweeps, as the reference's get_plan (:318)
    assert port[0]["config"]["cuda_sweep"] == "sharded"


def test_global_batch_is_split_by_sequence(port):
    from repro_torch.data.pipeline import SyntheticLM

    tokens = SyntheticLM(vocab_size=100, seq_len=16, global_batch=2, seed=3).batch(1)["tokens"]
    parts = [r["batch"] for r in port]
    np.testing.assert_array_equal(np.concatenate([p["tokens"] for p in parts], 1), tokens)
    targets = np.concatenate([p["targets"] for p in parts], 1)
    np.testing.assert_array_equal(targets[:, :-1], tokens[:, 1:])
    assert np.all(targets[:, -1] == 0)
    # a shard's last target is the next slice's first token
    np.testing.assert_array_equal(parts[0]["targets"][:, -1], parts[1]["tokens"][:, 0])


def test_compress_matches_reference_bitwise():
    import jax.numpy as jnp

    from repro.optim import compression as jcomp
    from repro_torch.optim import compression

    x = _inputs()["comp"] * 3.0
    r = np.linspace(-0.01, 0.01, 64).astype(np.float32)
    jc, jres = jcomp.compress(jnp.asarray(x), jnp.asarray(r))
    c, res = compression.compress(torch.from_numpy(x), torch.from_numpy(r))
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(jc.q))
    assert c.q.dtype == torch.int8 and float(c.scale) == float(jc.scale)
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(compression.decompress(c).numpy(),
                                  np.asarray(jcomp.decompress(jc)))


def test_compressed_allreduce_within_reference_bound(port):
    g = _inputs()["comp"]
    red, new_res = port[0]["compressed"]
    # SUM of 2 identical replicated shards = 2x the shard, up to the int8
    # error, which sums over the ranks too (test_multidevice.py:94)
    scale = float(np.abs(g).max()) / 127
    assert float(np.abs(red - 2 * g).max()) <= scale * 2 * 0.51 + 1e-6
    assert float(np.abs(new_res).max()) <= scale * 0.51
    np.testing.assert_array_equal(red, port[1]["compressed"][0])
