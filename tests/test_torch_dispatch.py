"""The port's dispatch registry (``repro_torch.kernels.dispatch``) against
the reference's ``repro.kernels.dispatch`` on the CPU.

* The cases of ``tests/test_dispatch.py`` on the port's module: key
  buckets, encode / decode, heuristics (the port's: the kernels' own
  tiling, 0, on every backend, and ``"fused"`` for the self family on the
  CPU, where the reference picks ``"jnp"``: the named differences of the
  module docstring), registered plans, the cache round trip at version 3,
  merging, heuristics never persisted, and a measured sweep (on the CPU
  over the jnp route and the kernels' plain versions) that registers and
  persists its winner.
* Cache files across packages: one written by ``repro.kernels.dispatch.
  save_cache`` (``"cpu"`` and ``"tpu"`` keys) loads in the port and never
  answers a ``"cuda"`` key; one the port writes loads in the reference;
  versions 1 and 2 load.
* ``dispatch_ss_attention`` against the reference's for backend "auto",
  "jnp" and "fused" (the port's plain route, the reference's interpret
  mode), causal and not; a ``seq_shards > 1`` key is kept and its
  heuristic is "sharded" (``test_torch_sharded.py``); "paged" and unknown
  backends raise; "sharded" and, on the CPU, "interpret" run the fused
  route.
* F3: ``attention_backend="jnp"`` reaches ``spectral_shift_attention``
  and never the fused route (monkeypatched counters); "auto" takes the
  plan's route.
* The engine: greedy tokens unchanged under registered decode and prefill
  plans (a view quantum that cuts the paged tick's table, a K5 chunk, a
  prefill tiling), equal to the JAX engine's; its warm-up's
  ``autotune_plan_resolutions_total`` equal to the JAX engine's with
  telemetry on; the trainer's warm-up (sweep, then the disk cache in a new
  registry) with its ``plan_resolution`` span and counters equal to the
  JAX trainer's.

Every test clears the registry and points the cache into ``tmp_path``.
Attention outputs hold 2e-5 of the reference's max-abs (the fp32
Newton-Schulz core amplifies rounding, ROADMAP Queue 3 P1; see
``tests/test_torch_core.py``), 1e-4 against the reference's interpret
mode (its Pallas kernels stream in blocks).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.attention import SSConfig as JSSConfig  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models.model import model_specs as jmodel_specs  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.telemetry import Telemetry as JTelemetry  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.attention import SSConfig  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.models import attention as mattention  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

TOL = 2e-5
INTERPRET_TOL = 1e-4


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    """A private cache file and clean registries, in both packages."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    for mod in (dispatch, jdispatch):
        mod.clear_registry()
        mod.set_cache_path(str(tmp_path / "autotune.json"))
    yield
    for mod in (dispatch, jdispatch):
        mod.clear_registry()
    dispatch.set_metrics(None)
    jdispatch.set_metrics(jdispatch.NullRegistry())


def rel_err(out, ref) -> float:
    out = out.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def qkv(n=192, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, n, d)).astype(np.float32) * 0.5,
            rng.normal(size=(2, n, d)).astype(np.float32) * 0.5,
            rng.normal(size=(2, n, d)).astype(np.float32))


# --------------------------------------------------------------------------
# the cases of tests/test_dispatch.py
# --------------------------------------------------------------------------
def test_key_buckets_sequence_length():
    k1 = dispatch.make_key(1000, 64, 64, torch.float32, False, backend="cuda")
    k2 = dispatch.make_key(1024, 64, 64, torch.float32, False, backend="cuda")
    k3 = dispatch.make_key(1025, 64, 64, torch.float32, False, backend="cuda")
    assert k1 == k2 and k1.n == 1024
    assert k3.n == 2048
    assert dispatch.make_key(100, 16, 16, "bfloat16", True, backend="cpu").dtype == "bfloat16"


def test_key_encode_decode_roundtrip():
    for family in ("self", "decode"):
        key = dispatch.make_key(4096, 64, 128, torch.bfloat16, True, backend="cuda",
                                family=family)
        assert dispatch.PlanKey.decode(key.encode()) == key
    assert (dispatch.make_key(4096, 64, 128, torch.bfloat16, True, backend="tpu").encode()
            == jdispatch.make_key(4096, 64, 128, jnp.bfloat16, True, backend="tpu").encode())
    key = dispatch.PlanKey.decode("tpu|n4096|c64|d128|bfloat16|causal")
    assert key.family == "self" and key.seq_shards == 1


def test_heuristics():
    """The kernels' own tiling (0) everywhere; "fused" on the CPU for the
    self family (the reference: "jnp"), the reference's decode routes."""
    for backend in ("cpu", "cuda"):
        for n in (512, 32768):
            plan = dispatch.heuristic_plan(
                dispatch.make_key(n, 64, 64, torch.bfloat16, True, backend=backend))
            assert (plan.impl, plan.block_n, plan.block_c, plan.source) == (
                "fused", 0, 0, "heuristic")
    jcpu = jdispatch.heuristic_plan(jdispatch.make_key(4096, 64, 64, jnp.float32, False,
                                                       backend="cpu"))
    assert jcpu.impl == "jnp"   # the named difference
    dec = dispatch.make_key(32768, 64, 128, torch.bfloat16, True, backend="cuda",
                            family="decode")
    assert dispatch.heuristic_plan(dec) == dispatch.Plan("paged", 0)
    cpu_dec = dispatch.make_key(32768, 64, 128, torch.bfloat16, True, backend="cpu",
                                family="decode")
    jcpu_dec = jdispatch.make_key(32768, 64, 128, jnp.bfloat16, True, backend="cpu",
                                  family="decode")
    assert dataclasses.astuple(dispatch.heuristic_plan(cpu_dec)) == dataclasses.astuple(
        jdispatch.heuristic_plan(jcpu_dec))


def test_register_overrides_heuristic():
    """A registered plan wins over the heuristic; for a "cuda" key only a
    kernel route may be registered: a plain-torch plan raises on
    resolution, whether registered or read from the cache."""
    cpu = dispatch.make_key(2048, 64, 64, torch.float32, False, backend="cpu")
    forced = dispatch.Plan(impl="jnp", block_n=256, source="registered")
    dispatch.register_plan(cpu, forced)
    assert dispatch.get_plan(cpu) == forced
    key = dispatch.make_key(2048, 64, 64, torch.float32, False, backend="cuda")
    tiled = dispatch.Plan(impl="fused", block_n=256, source="registered")
    dispatch.register_plan(key, tiled)
    assert dispatch.get_plan(key) == tiled
    for impl in ("jnp", "interpret"):
        dispatch.register_plan(key, dispatch.Plan(impl=impl, source="registered"))
        with pytest.raises(ValueError, match="attention_backend='jnp'"):
            dispatch.get_plan(key)
    dec = dispatch.make_key(2048, 64, 64, torch.float32, True, backend="cuda",
                            family="decode")
    with open(dispatch.cache_path(), "w") as f:
        json.dump({"version": 3, "plans": {dec.encode(): {"impl": "jnp", "block_n": 0}}}, f)
    with pytest.raises(ValueError, match="paged"):
        dispatch.get_plan(dec)


def test_cache_round_trip():
    key = dispatch.make_key(8192, 64, 128, torch.bfloat16, True, backend="cuda")
    dispatch.register_plan(key, dispatch.Plan(impl="fused", block_n=1024,
                                              source="autotuned"))
    path = dispatch.save_cache()
    with open(path) as f:
        payload = json.load(f)
    assert payload["version"] == 3 and key.encode() in payload["plans"]
    dispatch.clear_registry()
    dispatch.set_cache_path(path)
    assert dispatch.load_cache() == 1
    got = dispatch.get_plan(key)
    assert (got.impl, got.block_n, got.source) == ("fused", 1024, "cache")


def test_save_cache_merges_existing_entries():
    k1 = dispatch.make_key(1024, 64, 64, torch.float32, False, backend="cuda")
    dispatch.register_plan(k1, dispatch.Plan("fused", 512, source="autotuned"))
    dispatch.save_cache()
    dispatch.clear_registry()
    k2 = dispatch.make_key(4096, 64, 64, torch.float32, True, backend="cuda")
    dispatch.register_plan(k2, dispatch.Plan("fused", 1024, source="autotuned"))
    dispatch.save_cache()
    dispatch.clear_registry()
    assert dispatch.load_cache() == 2


def test_heuristic_plans_not_persisted():
    key = dispatch.make_key(1024, 64, 64, torch.float32, False, backend="cpu")
    dispatch.register_plan(key, dispatch.heuristic_plan(key))
    dispatch.save_cache()
    with open(dispatch.cache_path()) as f:
        assert f.read().count('"plans": {}') == 1


@pytest.mark.parametrize("family", ["self", "decode"])
def test_autotune_records_measured_plan(family):
    """On the CPU: the jnp route (gather route for decode) against the plain
    versions; the winner is registered, persisted and read back; the sweep
    is counted, and its launches stay out of the wrappers' counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    if family == "self":
        plan = dispatch.autotune(128, 16, 16, causal=False, reps=1)
        key = dispatch.make_key(128, 16, 16, torch.float32, False)
        assert plan.impl in ("jnp", "fused") and len(dispatch.SWEEPS[key.encode()]) == 2
    else:
        plan = dispatch.autotune_decode(256, 16, 16, block_size=16, reps=1,
                                        block_table_candidates=(0, 4),
                                        chunk_slot_candidates=(0, 4))
        key = dispatch.make_key(256, 16, 16, torch.float32, True, family="decode")
        assert plan.impl in ("jnp", "paged") and len(dispatch.SWEEPS[key.encode()]) == 5
    assert min(dispatch.SWEEPS[key.encode()], key=lambda r: r[1])[0] == plan
    assert plan.source == "autotuned"
    assert set(launch_counts().values()) == {0}
    assert dispatch.get_plan(key) == plan
    dispatch.clear_registry()
    dispatch.load_cache()
    got = dispatch.get_plan(key)
    assert (got.impl, got.block_n, got.block_table) == (plan.impl, plan.block_n,
                                                         plan.block_table)


def test_autotune_decode_keys_use_their_harness_once():
    key = dispatch.make_key(1024, 16, 16, torch.float32, True, family="decode")
    calls = []

    def tune(k):
        calls.append(k)
        plan = dispatch.Plan(impl="paged", block_n=4, block_table=4, source="autotuned")
        dispatch.register_plan(k, plan)
        return plan

    assert dispatch.get_plan(key, autotune_enabled=True, tune_fn=tune).impl == "paged"
    assert dispatch.get_plan(key, autotune_enabled=True, tune_fn=tune).block_table == 4
    assert calls == [key]


# --------------------------------------------------------------------------
# cache files across the two packages
# --------------------------------------------------------------------------
def test_jax_cache_loads_and_never_answers_cuda_keys(tmp_path):
    path = str(tmp_path / "jax.json")
    jcpu = jdispatch.make_key(1024, 64, 64, jnp.float32, False, backend="cpu")
    jtpu = jdispatch.make_key(4096, 64, 128, jnp.bfloat16, True, backend="tpu")
    jdispatch.register_plan(jcpu, jdispatch.Plan("interpret", 256, block_c=32,
                                                 source="autotuned"))
    jdispatch.register_plan(jtpu, jdispatch.Plan("fused", 1024, source="autotuned"))
    jdispatch.save_cache(path)
    dispatch.set_cache_path(path)
    assert dispatch.load_cache() == 2
    cuda = dispatch.make_key(4096, 64, 128, torch.bfloat16, True, backend="cuda")
    assert dispatch.get_plan(cuda).source == "heuristic"
    cpu = dispatch.make_key(1024, 64, 64, torch.float32, False, backend="cpu")
    got = dispatch.get_plan(cpu)
    assert (got.impl, got.block_n, got.block_c, got.source) == ("interpret", 256, 32,
                                                                "cache")
    # the port runs such a plan on the CPU through the plain versions
    q, k, v = (torch.from_numpy(a) for a in qkv(n=200, d=64))
    dispatch.register_plan(dispatch.make_key(200, 16, 64, torch.float32, False,
                                             backend="cpu"), got)
    out = dispatch.dispatch_ss_attention(q, k, v, SSConfig(num_landmarks=16))
    assert rel_err(out, ops.ss_attention_fused(q, k, v, SSConfig(num_landmarks=16))) == 0


def test_port_cache_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "port.json")
    key = dispatch.make_key(512, 64, 128, torch.bfloat16, True, backend="cuda",
                            family="decode")
    dispatch.register_plan(key, dispatch.Plan("paged", 8, block_table=4,
                                              source="autotuned"))
    dispatch.save_cache(path)
    assert jdispatch.load_cache(path) == 1
    jkey = jdispatch.make_key(512, 64, 128, jnp.bfloat16, True, backend="cuda",
                              family="decode")
    got = jdispatch.get_plan(jkey)
    assert (got.impl, got.block_n, got.block_table, got.source) == ("paged", 8, 4, "cache")


@pytest.mark.parametrize("version,entry,want", [
    (1, {"impl": "fused", "block_n": 256}, (256, 0, 0)),
    (2, {"impl": "fused", "block_n": 256, "block_c": 16}, (256, 16, 0)),
])
def test_legacy_cache_versions_load(version, entry, want):
    key = dispatch.make_key(4096, 64, 64, torch.float32, False, backend="cuda")
    with open(dispatch.cache_path(), "w") as f:
        json.dump({"version": version, "plans": {key.encode(): entry}}, f)
    assert dispatch.load_cache() == 1
    got = dispatch.get_plan(key)
    assert (got.block_n, got.block_c, got.block_table, got.source) == (*want, "cache")


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["auto", "jnp", "fused"])
@pytest.mark.parametrize("causal", [False, True])
def test_dispatch_matches_the_reference(backend, causal):
    q, k, v = qkv()
    jbackend, tol = (("interpret", INTERPRET_TOL) if backend == "fused"
                     else (backend, TOL))
    ref = jdispatch.dispatch_ss_attention(
        *map(jnp.asarray, (q, k, v)), JSSConfig(num_landmarks=16, causal=causal),
        backend=jbackend, interpret=True)
    out = dispatch.dispatch_ss_attention(
        *map(torch.from_numpy, (q, k, v)), SSConfig(num_landmarks=16, causal=causal),
        backend=backend)
    assert rel_err(out, ref) < tol


def test_routes_and_refusals():
    q, k, v = (torch.from_numpy(a) for a in qkv(n=96, d=16))
    cfg = SSConfig(num_landmarks=8)
    fused = ops.ss_attention_fused(q, k, v, cfg)
    for backend in ("sharded", "interpret"):
        assert torch.equal(dispatch.dispatch_ss_attention(q, k, v, cfg, backend=backend),
                           fused)
    with pytest.raises(ValueError, match="decode"):
        dispatch.dispatch_ss_attention(q, k, v, cfg, backend="paged")
    with pytest.raises(ValueError, match="unknown attention backend"):
        dispatch.dispatch_ss_attention(q, k, v, cfg, backend="cuda")
    # a context-parallel key (kernels/sharded.py): keyed, never swept
    sp = dispatch.make_key(1024, 16, 16, torch.float32, False, seq_shards=4)
    assert sp.seq_shards == 4 and sp.encode().endswith("|sp4")
    assert dispatch.heuristic_plan(sp).impl == "sharded"
    with pytest.raises(ValueError, match="family"):
        dispatch.make_key(128, 16, 16, torch.float32, False, family="wat")
    # the CUDA kernels' tilings: whole KEY_TILE / QUERY_TILE, K4's 128 rows
    dispatch.check_tiling(0)
    dispatch.check_tiling(192)
    dispatch.check_tiling(256, backward=True)
    for bad, kw in ((96, {}), (192, {"backward": True}), (-128, {})):
        with pytest.raises(ValueError, match="block_n"):
            dispatch.check_tiling(bad, **kw)
    with pytest.raises(ValueError, match="block_c"):
        dispatch.check_tiling(256, 32)


def test_plain_versions_take_the_kernels_tilings():
    """Each plain version takes every argument of its CUDA launch function
    (the tilings included, ignored), so it can stand in for the kernel on
    the card (``chip_smoke.plain_route``), and ignores the tiling here."""
    import inspect

    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ss_attention as sa
    from repro_torch.kernels import ss_attention_bwd as sb

    for cuda, plain in ((sa._landmark_summary_cuda, sa.landmark_summary_plain),
                        (sa._query_side_cuda, sa.query_side_plain),
                        (sb._landmark_summary_bwd_cuda, sb.landmark_summary_bwd_plain),
                        (sb._query_side_bwd_cuda, sb.query_side_bwd_plain),
                        (pd._paged_row_stats_cuda, pd.paged_row_stats_plain)):
        assert set(inspect.signature(cuda).parameters) <= set(
            inspect.signature(plain).parameters), cuda.__name__
    q, k, v = (torch.from_numpy(a) for a in qkv(n=130, d=16))
    cfg = SSConfig(num_landmarks=16, causal=True)
    assert torch.equal(ops.ss_attention_fused(q, k, v, cfg, block_n=96),
                       ops.ss_attention_fused(q, k, v, cfg))


@pytest.mark.parametrize("backend", ["jnp", "auto"])
def test_attention_backend_reaches_its_route(backend, monkeypatch):
    """F3: ``attention_backend="jnp"`` runs the plain-torch spectral shift
    and never the fused route; "auto" runs the plan's (fused on the CPU)."""
    calls = []
    real_ss, real_fused = dispatch.spectral_shift_attention, ops.ss_attention_fused
    monkeypatch.setattr(dispatch, "spectral_shift_attention",
                        lambda *a, **kw: calls.append("jnp") or real_ss(*a, **kw))
    monkeypatch.setattr(ops, "ss_attention_fused",
                        lambda *a, **kw: calls.append("fused") or real_fused(*a, **kw))
    cfg = base.reduced(get_config("qwen2-7b"), attention_backend=backend)
    q = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 2, 160, 32)).astype(np.float32) * 0.5)
    out = mattention._core_attention(cfg, "spectral_shift_fused", q, q, q, causal=True)
    ref = mattention._core_attention(cfg, "spectral_shift", q, q, q, causal=True)
    assert calls == (["jnp"] if backend == "jnp" else ["fused"])
    assert float((out - ref).abs().max() / ref.abs().max()) < TOL


# --------------------------------------------------------------------------
# the engine and the trainer
# --------------------------------------------------------------------------
PROMPTS = ((3, 12), (1, 45))


@pytest.fixture(scope="module")
def weights():
    jcfg = jbase.reduced(jget_config("qwen2-7b"))
    jparams = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _serve_kw():
    return dict(max_lanes=1, max_seq=96, block_size=8, prefill_impl="ss_fused",
                decode_impl="paged")


def _run(eng, request_cls, vocab):
    rng = np.random.default_rng(0)
    for uid, n in PROMPTS:
        eng.submit(request_cls(uid, rng.integers(3, vocab, size=n).tolist(),
                               max_new_tokens=6))
    return eng.run()


def test_engine_tokens_unchanged_under_registered_plans(weights):
    jcfg, jparams, params = weights
    cfg = base.reduced(get_config("qwen2-7b"))
    serve = base.ServeConfig(**_serve_kw())
    cold = ServeEngine(cfg, params, serve=serve, device="cpu")
    assert cold.stats()["decode_plan"] == "jnp/b128/heuristic"
    assert (cold._view_quantum, cold._chunk_slots, cold._prefill_block) == (0, 0, 0)
    base_out = _run(cold, Request, cfg.vocab_size)
    dec = dispatch.make_key(96, cfg.num_landmarks, cfg.resolved_head_dim,
                            cfg.compute_dtype, True, backend="cpu", family="decode")
    pre = dispatch.make_key(96, cfg.num_landmarks, cfg.resolved_head_dim,
                            cfg.compute_dtype, False, backend="cpu")
    dispatch.register_plan(dec, dispatch.Plan("paged", 4, block_table=4,
                                              source="registered"))
    dispatch.register_plan(pre, dispatch.Plan("fused", 256, source="registered"))
    eng = ServeEngine(cfg, params, serve=serve, device="cpu")
    assert eng.stats()["decode_plan"] == "paged/b4/t4/registered"
    assert (eng._view_quantum, eng._chunk_slots, eng._prefill_block) == (4, 4, 256)
    seen = []
    real_step = eng._step
    eng._step = lambda table, *a: seen.append((table.shape[1], table.is_contiguous(),
                                               dispatch.current_tiling())) \
        or real_step(table, *a)
    assert _run(eng, Request, cfg.vocab_size) == base_out
    # the tables cut to the quantum, contiguous as K5 takes them on the card;
    # the tick runs at the plans' tilings, which the wrappers read on the card
    tiled = dispatch.Tiling(block_n=256, chunk_slots=4)
    assert set(seen) == {(4, True, tiled), (8, True, tiled)}
    assert dispatch.current_tiling() == dispatch.Tiling()
    jeng = JServeEngine(jcfg, jparams, serve=jbase.ServeConfig(**_serve_kw()))
    assert _run(jeng, JRequest, jcfg.vocab_size) == base_out


def test_engine_plan_resolutions_equal_the_jax_engine(weights):
    jcfg, jparams, params = weights
    eng = ServeEngine(base.reduced(get_config("qwen2-7b")), params,
                      serve=base.ServeConfig(**_serve_kw(), telemetry=True), device="cpu")
    jeng = JServeEngine(jcfg, jparams,
                        serve=jbase.ServeConfig(**_serve_kw(), telemetry=True))
    name = "autotune_plan_resolutions_total"
    got = eng.telemetry.metrics.snapshot()[name]
    assert got == jeng.telemetry.metrics.snapshot()[name]
    assert got == {"outcome=miss_heuristic": {"value": 2.0}}


def test_trainer_warmup_equals_the_jax_trainer(tmp_path, monkeypatch):
    """A sweep at the train shape into ``autotune_cache``, then (a new
    registry, as in a new process) the plan from that file named by
    ``REPRO_AUTOTUNE_CACHE``, which ``get_plan`` reads itself (outcome
    "disk"; with ``autotune_cache`` set the warm-up loads the file first and
    the outcome is "memory", as in the reference): the same counters and
    ``plan_resolution`` spans as the reference's trainer."""
    from repro.launch.mesh import make_local_mesh
    from repro.train.trainer import Trainer as JTrainer

    shape = ("t", 128, 2, "train")
    runs = {}
    for side in ("jax", "port"):
        cache = str(tmp_path / f"{side}.json")
        mod = jbase if side == "jax" else base
        cfg = mod.reduced((jget_config if side == "jax" else get_config)("qwen2-7b"),
                          attention_impl="spectral_shift_fused", autotune=True,
                          autotune_cache=cache)
        snaps = []
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", cache)
        for i in range(2):
            (jdispatch if side == "jax" else dispatch).clear_registry()
            if i:
                cfg = dataclasses.replace(cfg, autotune_cache="")
            tcfg = mod.TrainConfig(checkpoint_dir=str(tmp_path / f"{side}{i}"))
            if side == "jax":
                tel = JTelemetry()
                JTrainer(cfg, tcfg, mod.ShapeConfig(*shape), make_local_mesh(1),
                         telemetry=tel)
            else:
                tel = Telemetry()
                trainer = Trainer(cfg, tcfg, mod.ShapeConfig(*shape), device="cpu",
                                  telemetry=tel)
                assert trainer.plan.source == ("autotuned" if i == 0 else "cache")
            snap = tel.metrics.snapshot()
            snaps.append({k: snap[k] for k in ("autotune_plan_resolutions_total",
                                               "autotune_sweeps_total") if k in snap}
                         | {"spans": snap["span_seconds"]["span=plan_resolution"]["count"]})
        runs[side] = snaps
    assert runs["port"] == runs["jax"]
    assert runs["port"][1]["autotune_plan_resolutions_total"] == {
        "outcome=disk": {"value": 1.0}}
    assert "autotune_sweeps_total" not in runs["port"][1]
