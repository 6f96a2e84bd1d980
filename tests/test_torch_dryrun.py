"""The dry-run in the port (``launch/dryrun.py``, ``AbstractMesh``,
``make_production_mesh``, ``abstract_params`` / ``logical_axes``, the
decode cells' ``batch_specs``, ``make_prefill_step`` / ``make_serve_step``,
``kernels/cost.py``), on the CPU.

* ``abstract_params`` / ``logical_axes`` / ``count_params`` against the
  reference's for every registry arch at full width (shapes, dtypes, axes,
  counts), and decode ``batch_specs`` at ``decode_32k`` and ``long_500k``
  (absorbed MLA's cache leaves with the port's unit kv-head axis dropped);
* ``make_prefill_step`` / ``make_serve_step`` at 1 layer against the
  reference's (jitted) on the same weights and cache: logits 5e-5 (P1);
* ``moved_bytes`` of the recorded collectives against the reference's
  ``parse_collectives`` on HLO lines written from the same (op, bytes,
  group), group sizes 1, 2, 4, 16 and 256;
* the prediction against a real run: ``run_cell`` of reduced Qwen2-7B's
  train cell on a 2 x 2 ``AbstractMesh`` against the same step on 4 gloo
  ranks (``Mesh.traffic``, ``FlopCounterMode`` on real tensors): the
  collectives' counts and bytes by op, the state bytes and the FLOPs
  exactly, the kernels' ops counted, not zero;
* the dense arches' ``state_bytes_per_device`` on the 16 x 16 mesh against
  the reference's ``_sharded_bytes`` under ``shardings_for`` with the same
  parameter rules, in a subprocess on 256 fake devices;
* the multi-pod production mesh: Qwen2-7B's train cell at 2 layers under
  the fused attention and under its own "chunked" attention (keys
  all-gathered over the sequence shard the cell needs), the port's
  counterpart of ``test_production_mesh_lowering_smoke`` (R1); Whisper's
  train cell at 1 + 1 layers traces there too (its encoder whole on each
  rank, its decoder's keys all-gathered, cross attention's global Q~
  all-reduced);
* four rows of PERF.md's kernel table recomputed from the moved formulas.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# the reference's dry-run module sets XLA_FLAGS at import: restore it, so
# that no spawned rank or subprocess inherits 512 devices
_saved_flags = os.environ.get("XLA_FLAGS")
from repro.launch.dryrun import _sharded_bytes, parse_collectives  # noqa: E402,F401

if _saved_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved_flags

ARCHS = ["qwen2-72b", "qwen2-7b", "deepseek-67b", "granite-20b", "xlstm-350m",
         "whisper-base", "hymba-1.5b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
         "llava-next-34b", "paper-bert"]
DENSE = ["qwen2-72b", "qwen2-7b", "deepseek-67b", "granite-20b"]
SEQ, BATCH = 64, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This process's steps on one thread, as each spawned rank runs:
    beside other test workers, more threads than cores slow them many
    times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _axes_leaves(tree) -> list:
    """A port axes tree's tuples, in leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _axes_leaves(tree[k])]
    if isinstance(tree, list):
        return [a for t in tree for a in _axes_leaves(t)]
    return [tuple(tree)]


def _ref_leaves(tree):
    import jax

    return jax.tree.leaves(tree)


def _ref_axes(tree) -> list:
    import jax

    return [tuple(a) for a in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))]


def _both(arch):
    from repro.configs.registry import get_config as ref_config
    from repro_torch.configs.registry import get_config

    return get_config(arch), ref_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    import jax.numpy as jnp
    from repro.models.model import model_specs as ref_specs
    from repro.models.params import abstract_params as ref_abstract
    from repro.models.params import count_params as ref_count
    from repro.models.params import logical_axes as ref_axes
    from repro_torch.models.model import model_specs, torch_dtype
    from repro_torch.models.params import (abstract_params, count_params, logical_axes,
                                           tree_leaves)

    cfg, rcfg = _both(arch)
    specs, rspecs = model_specs(cfg), ref_specs(rcfg)
    mine = tree_leaves(abstract_params(specs, dtype=torch_dtype(cfg.param_dtype)))
    ref = _ref_leaves(ref_abstract(rspecs, dtype=jnp.dtype(rcfg.param_dtype)))
    assert all(t.is_meta for t in mine)
    assert [(tuple(t.shape), _dtype_name(t.dtype)) for t in mine] == \
        [(tuple(s.shape), str(s.dtype)) for s in ref]
    assert _axes_leaves(logical_axes(specs)) == _ref_axes(ref_axes(rspecs))
    assert count_params(specs) == ref_count(rspecs)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_decode_batch_specs_match_reference(shape_name):
    from repro.configs.base import SHAPE_PRESETS as REF_PRESETS
    from repro.configs.registry import batch_specs as ref_batch_specs
    from repro_torch.configs.base import SHAPE_PRESETS
    from repro_torch.configs.registry import batch_specs
    from repro_torch.models.params import tree_leaves

    for arch in ARCHS:
        cfg, rcfg = _both(arch)
        specs, axes = batch_specs(cfg, SHAPE_PRESETS[shape_name])
        rspecs, raxes = ref_batch_specs(rcfg, REF_PRESETS[shape_name])
        assert sorted(specs) == sorted(rspecs) == ["cache", "tokens"]
        mine = [(tuple(t.shape), _dtype_name(t.dtype), a)
                for t, a in zip(tree_leaves(specs), _axes_leaves(axes))]
        ref = [(tuple(s.shape), str(s.dtype), a)
               for s, a in zip(_ref_leaves(rspecs), _ref_axes(raxes))]
        assert [_drop_unit_kv_axis(m, r) for m, r in zip(mine, ref)] == ref, arch
        assert len(mine) == len(ref)


def _drop_unit_kv_axis(mine: tuple, ref: tuple) -> tuple:
    """The port's absorbed-MLA cache leaves carry a unit kv-head axis after
    the rows (they page and decode as GQA with one wide kv head); without
    it they are the reference's."""
    shape, dt, axes = mine
    if len(shape) == len(ref[0]) + 1 and axes[-3] == "kv_heads" and shape[-3] == 1:
        return shape[:-3] + shape[-2:], dt, axes[:-3] + axes[-2:]
    return mine


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_in_the_engine_storage_keys(arch):
    """``storage_from_tree`` stacks a decode cell's cache tree under the
    keys and layer order of the engine's storage (``storage_layout``),
    each leaf (layers, batch, ...) of the layout's per-layer shape."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import batch_specs, get_config
    from repro_torch.serve.kv_cache import storage_from_tree, storage_layout

    cfg = get_config(arch)
    specs, _ = batch_specs(cfg, ShapeConfig("decode", 256, 2, "decode"))
    got = storage_from_tree(specs["cache"])
    want = storage_layout(cfg, 256)
    assert list(got) == list(want)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == (len(leaf.layers), 2, *leaf.shape), key


def _one_layer():
    from repro.configs.base import reduced as ref_reduced
    from repro.configs.registry import get_config as ref_config
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config

    return (reduced(get_config("qwen2-7b"), num_layers=1),
            ref_reduced(ref_config("qwen2-7b"), num_layers=1))


def test_prefill_and_serve_steps_match_reference():
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig as RefShape
    from repro.configs.registry import batch_specs as ref_batch_specs
    from repro.models.model import model_specs as ref_specs
    from repro.models.params import init_params
    from repro.train.train_step import make_prefill_step as ref_prefill
    from repro.train.train_step import make_serve_step as ref_serve
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.train_step import make_prefill_step, make_serve_step

    cfg, rcfg = _one_layer()
    rparams = init_params(ref_specs(rcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rparams))
    tokens = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 80)).astype(np.int32)
    want = np.asarray(jax.jit(ref_prefill(rcfg))(rparams, {"tokens": jnp.asarray(tokens)}))
    got = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(tokens)}).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    # a cache of 3 decode steps from zeros (the reference's), then one step
    rspecs, _ = ref_batch_specs(rcfg, RefShape("decode", 64, 2, "decode"))
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), rspecs["cache"])
    step = jax.jit(ref_serve(rcfg))
    for t in range(3):
        _, cache = step(rparams, cache, jnp.asarray(tokens[:, t:t + 1]))
    want, _ = step(rparams, cache, jnp.asarray(tokens[:, 3:4]))
    mine = params_from_numpy(jax.tree.map(np.asarray, cache))
    got, new = make_serve_step(cfg)(params, mine, torch.from_numpy(tokens[:, 3:4]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    assert new["pos"].tolist() == [4, 4]


def _hlo_line(i: int, op: str, nbytes: int, group: int, devices: int = 256) -> str:
    assert nbytes % 4 == 0 and devices % group == 0
    name = {"all_reduce": "all-reduce", "all_gather": "all-gather",
            "all_to_all": "all-to-all"}[op]
    return (f"  %{name}.{i} = f32[{nbytes // 4}]{{0}} {name}(%p{i}), channel_id={i}, "
            f"replica_groups=[{devices // group},{group}]<=[{devices}]")


@pytest.mark.parametrize("group", [1, 2, 4, 16, 256])
def test_moved_bytes_match_parse_collectives(group):
    from repro_torch.launch.dryrun import collective_stats

    traffic = {("all_reduce", group): (3, 3 * 4096), ("all_gather", group): (2, 2 * 8192),
               ("all_to_all", group): (1, 1024)}
    lines = []
    for op, g in traffic:
        calls, nbytes = traffic[(op, g)]
        lines += [_hlo_line(len(lines) + k, op, nbytes // calls, g) for k in range(calls)]
    want = parse_collectives("\n".join(lines))
    got = collective_stats(traffic)
    assert sorted(got) == sorted(want)
    for op in want:
        assert got[op]["count"] == want[op]["count"]
        assert got[op]["result_bytes"] == want[op]["result_bytes"]
        assert got[op]["moved_bytes"] == pytest.approx(want[op]["moved_bytes"], rel=1e-12)


# --------------------------------------------------------------------------
# The prediction against a real 4-rank run.
# --------------------------------------------------------------------------
def _reduced_overrides() -> dict:
    """``reduced()``'s fields for qwen2-7b as ``run_cell``'s overrides, with
    the fused attention (plain versions on the CPU) and remat ss_stats."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config

    full = get_config("qwen2-7b")
    red = reduced(full, attention_impl="spectral_shift_fused", attention_backend="interpret",
                  remat="ss_stats", num_landmarks=8)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


def _shape():
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig("train_4k", SEQ, BATCH, "train")


def _real_rank(mesh, root: str) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.cost import register_flop_formulas
    from repro_torch.launch.dryrun import collectives_since
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.trainer import Trainer

    register_flop_formulas()
    cfg = dataclasses.replace(get_config("qwen2-7b"), **_reduced_overrides())
    tr = Trainer(cfg, TrainConfig(checkpoint_dir=os.path.join(root, str(mesh.rank)),
                                  checkpoint_every=0), _shape(), mesh, device="cpu")
    state = sum(t.numel() * t.element_size() for t in tree_leaves(tr.params))
    state += 2 * sum(t.numel() * 4 for t in tree_leaves(tr.params))
    before = mesh.traffic()
    with FlopCounterMode(display=False) as fc:
        tr.run(1)
    counts = fc.get_flop_counts()["Global"]
    return {"flops": float(sum(counts.values())),
            "by_op": {str(k): float(v) for k, v in counts.items()},
            "collectives": collectives_since(mesh, before), "state": float(state)}


@pytest.fixture(scope="module")
def real_run(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_local

    return spawn_local(_real_rank, (2, 2), ("data", "model"),
                       args=(str(tmp_path_factory.mktemp("dryrun_real")),), device="cpu",
                       timeout_s=120.0)


def test_run_cell_predicts_a_real_run(real_run):
    from repro_torch.distributed.mesh import AbstractMesh
    from repro_torch.launch.dryrun import run_cell

    for rank, real in enumerate(real_run):
        cell = run_cell("qwen2-7b", "train_4k", False, cfg_overrides=_reduced_overrides(),
                        mesh=AbstractMesh((2, 2), ("data", "model"), rank=rank),
                        shape=_shape())
        assert cell["collectives"] == real["collectives"], rank
        assert cell["state_bytes_per_device"] == real["state"], rank
        assert cell["flops_by_op"] == real["by_op"], rank
        assert cell["flops_total"] == real["flops"], rank
        for op in ("landmark_summary", "query_side", "landmark_summary_bwd",
                   "query_side_bwd"):
            assert cell["flops_by_op"][f"repro_torch.{op}"] > 0, op
        assert set(cell["collectives"]) == {"all-reduce", "all-gather"}


def test_dense_state_bytes_match_reference_sharded_bytes():
    from conftest import run_subprocess
    from repro_torch.configs.base import SHAPE_PRESETS
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import param_rules
    from repro_torch.launch.dryrun import cell_state
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    shape = SHAPE_PRESETS["train_4k"]
    cases = {}
    for arch in DENSE:
        cfg = get_config(arch)
        overrides = {"seq": "model"} if cfg.num_heads % 16 else {}
        rules = {k: (list(v) if v else None) for k, v in
                 param_rules(mesh, overrides, cfg).items()}
        cases[arch] = {"rules": rules, "port": cell_state(cfg, shape, mesh, overrides)[0]}
    out = run_subprocess(f"""
import json
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.distributed.sharding import sharding_rules, shardings_for
from repro.launch.dryrun import _sharded_bytes
from repro.models.model import model_specs
from repro.models.params import abstract_params, logical_axes

cases = json.loads({json.dumps(json.dumps(cases))})
mesh = jax.make_mesh((16, 16), ("data", "model"))
out = {{}}
for arch, case in cases.items():
    cfg = get_config(arch)
    specs = model_specs(cfg)
    params = abstract_params(specs, dtype=jnp.dtype(cfg.param_dtype))
    rules = {{k: (tuple(v) if v else None) for k, v in case["rules"].items()}}
    with mesh, sharding_rules(mesh, rules):
        sh = shardings_for(mesh, logical_axes(specs), params)
        moments = abstract_params(specs, dtype=jnp.float32)
        out[arch] = _sharded_bytes(params, sh, 256) + 2 * _sharded_bytes(moments, sh, 256)
print(json.dumps(out))
""", num_devices=256)
    ref = json.loads(out.strip().splitlines()[-1])
    for arch in DENSE:
        assert cases[arch]["port"] == ref[arch], arch


def test_multi_pod_train_cell():
    from repro_torch.launch.dryrun import run_cell

    res = run_cell("qwen2-7b", "train_4k", multi_pod=True, probe=False,
                   attention="spectral_shift_fused", cfg_overrides={"num_layers": 2})
    assert res["devices"] == 512 and res["flops_total"] > 0
    assert res["collectives"], "expected collectives on the production mesh"
    assert res["flops_by_op"]["repro_torch.landmark_summary_sp"] > 0
    # its own chunked attention traces under the sequence shard too: K / V
    # all-gathered over "model"; so does Whisper's, whose cross attention
    # all-reduces its global query landmarks
    own = run_cell("qwen2-7b", "train_4k", multi_pod=True, probe=False,
                   cfg_overrides={"num_layers": 2})
    assert own["attention"] == "chunked" and own["flops_total"] > 0
    assert own["collectives"]["all-gather"]["count"] > 0
    whisper = run_cell("whisper-base", "train_4k", multi_pod=True, probe=False,
                       cfg_overrides={"num_layers": 1, "encoder_layers": 1})
    assert whisper["flops_total"] > 0
    assert whisper["collectives"]["all-gather"]["count"] > 0
    assert whisper["collectives"]["all-reduce"]["count"] > 0


def test_kernel_table_bounds_from_the_cost_formulas():
    """Rows of PERF.md's kernel table from the moved formulas: K1 serving
    (b=28 c=64 n=352 kv_valid=333 d=128 bf16: 0.0017 ms, bytes), K2 and K3
    at paper-bert's training shape (b=64 n=4096 c=64 d=64 bf16, causal:
    0.0304 and 0.0407 ms, bytes), K5 at granite-20b's decode shape (lanes
    4, hkv 1, r 48, bs 64, kv_valid 48/200/333/480 fp32: 0.00039 ms,
    operations)."""
    from repro_torch.kernels import cost

    b, c, d = 28, 64, 128
    k1 = cost.landmark_summary_cost(b, c, 333, d, d, b * c * 333, q_bytes=2, kv_bytes=2,
                                    out_bytes=2, stats=False)
    assert cost.bound_ms(*k1, "bfloat16") == (pytest.approx(0.0017, abs=5e-5), "bytes")
    b, n, d = 64, 4096, 64
    k2 = cost.query_side_cost(b, n, c, d, d, b * cost.f_side_pairs(n, c, seg=n // c), es=2)
    assert cost.bound_ms(*k2, "bfloat16") == (pytest.approx(0.0304, abs=5e-5), "bytes")
    k3 = cost.landmark_summary_bwd_cost(b, c, n, d, d, b * cost.b_side_pairs(c, n, seg=n // c),
                                        es=2)
    assert cost.bound_ms(*k3, "bfloat16") == (pytest.approx(0.0407, abs=5e-5), "bytes")
    k5 = cost.paged_row_stats_cost([48, 200, 333, 480], 1, 48, 128, 128, 64)
    assert cost.bound_ms(*k5, "float32") == (pytest.approx(0.00039, abs=5e-6), "operations")
