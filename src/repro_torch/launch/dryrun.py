"""The dry-run (``repro/launch/dryrun.py``): one rank's step of every
(arch x shape x mesh) cell on the production mesh, traced on the ``meta``
device (shapes only, nothing allocated), with its FLOPs, collectives and
state bytes counted.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``
and is skipped if that file exists (a restartable sweep; ``--force``
reruns it). A cell the port refuses is written with ``status: "error"``
and the refusal's words, as the reference writes its tracebacks.

``run_cell`` applies the reference's overrides (``dryrun.py:183-200``:
the sequence over "model" where the heads do not divide it, the
``long_500k`` and decode rules) and ``apply_seq_sharding_config``, passes
the Trainer's ``_check_supported``, then runs the rank's step on an
``AbstractMesh`` (``launch/mesh.py:make_production_mesh``, rank 0) under
``torch.utils.flop_counter.FlopCounterMode``:

* train: value-and-grad and AdamW (``train/train_step.py:make_train_step``)
  on the rank's parameter slices (``sharding.param_layout``) and its rows
  and sequence slice (Whisper's frames by the same rows, whole along
  their own axis, so the encoder's FLOPs count whole on each rank where
  the reference's GSPMD would split its fused attention over the
  sequence's shards; LLaVA's patches by the same rows and the rank's
  slice of the joint sequence [patches, text]);
* prefill: ``make_prefill_step`` on the same layout;
* decode: ``make_serve_step``. The port's ``serve/decode.py`` takes no
  tensor-parallel layout, so decode cells run with whole parameters and a
  whole cache a row, the rows over the "cache_batch" rule's axes (the
  cell's ``layout`` says so).

It records, under the reference's keys where one exists:
``param_count``; ``flops_total``, the rank's count (the matrix products
and the kernels' formulas, ``kernels/cost.py``; no elementwise work);
``state_bytes_per_device``: the rank's parameter slices plus two moments
in ``opt_state_dtype`` (train), or the cache (decode); ``collectives``:
``{op: {count, result_bytes, moved_bytes}}`` from the mesh's recorded
calls with the reference's ring factors (``collective_stats``); and
``trace_s`` in place of ``lower_s``. Named differences (ROADMAP): no
``compile_s``, ``memory_analysis`` or ``hlo_lines``; no L2 / L4 probe
(``probe`` is taken and not read: torch runs every layer); the non-dense
families keep replicated parameters; decode caches are not sequence-
sharded.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import SHAPE_PRESETS, ModelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import ARCH_IDS, batch_specs, get_config
from repro_torch.data.pipeline import make_global_batch
from repro_torch.distributed.sharding import (_merged, _rule_axes, apply_seq_sharding_config,
                                              param_layout, sharding_rules)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import model_specs, torch_dtype
from repro_torch.models.params import abstract_params, count_params, shard_tree, tree_leaves
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.train_step import make_prefill_step, make_serve_step, make_train_step
from repro_torch.train.trainer import _check_supported

# a mesh collective's op -> the reference's HLO op (``dryrun.py:51``);
# point-to-point ops keep their own names
HLO_OPS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
           "all_to_all": "all-to-all"}


def moved_bytes(op: str, result_bytes: float, group: int) -> float:
    """The bytes a rank moves for one collective with ``result_bytes`` of
    result over ``group`` ranks, by the reference's ring factors
    (``dryrun.py:69``): all-gather and all-to-all out (g-1)/g, all-reduce
    out 2(g-1)/g, reduce-scatter out (g-1), a point-to-point transfer
    out."""
    g = max(group, 1)
    factor = {"all-gather": (g - 1) / g, "all-to-all": (g - 1) / g,
              "all-reduce": 2 * (g - 1) / g, "reduce-scatter": g - 1}.get(op, 1.0)
    return result_bytes * factor


def collective_stats(traffic: dict) -> dict:
    """``{op: {count, result_bytes, moved_bytes}}`` of a mesh's ``traffic()``
    ({(op, group size): (calls, result bytes)}), keyed by the reference's
    HLO op names."""
    stats: dict = {}
    for (op, group), (calls, nbytes) in sorted(traffic.items()):
        name = HLO_OPS.get(op, op)
        rec = stats.setdefault(name, {"count": 0, "result_bytes": 0, "moved_bytes": 0.0})
        rec["count"] += calls
        rec["result_bytes"] += nbytes
        # equal calls in a group: the factor applies to their sum
        rec["moved_bytes"] += moved_bytes(name, nbytes, group)
    return stats


def collectives_since(mesh, before: dict) -> dict:
    """``collective_stats`` of the calls ``mesh`` made since its
    ``traffic()`` was ``before``."""
    diff = {}
    for k, (calls, nbytes) in mesh.traffic().items():
        c0, b0 = before.get(k, (0, 0))
        if calls > c0:
            diff[k] = (calls - c0, nbytes - b0)
    return collective_stats(diff)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _local(specs: dict, axes: dict, mesh, overrides) -> dict:
    """A decode cell's inputs on one rank: the rows ("cache_batch") over
    the rule's axes, every other dim whole."""
    rows = _rule_axes(mesh, _merged(overrides), "cache_batch")
    n = mesh.axis_size(rows)
    b = specs["tokens"].shape[0]
    if b % n:
        raise ValueError(f"a decode batch of {b} rows does not split over {rows} "
                         f"({n} ranks)")

    def cut(tree, ax):
        if isinstance(tree, dict):
            return {k: cut(tree[k], ax[k]) for k in tree}
        if isinstance(tree, list):
            return [cut(t, a) for t, a in zip(tree, ax)]
        return torch.empty([s // n if a == "cache_batch" else s
                            for s, a in zip(tree.shape, ax)], dtype=tree.dtype, device="meta")

    return cut(specs, axes)


def cell_state(cfg: ModelConfig, shape: ShapeConfig, mesh, overrides: Optional[dict] = None,
               tcfg: Optional[TrainConfig] = None) -> tuple:
    """(state bytes, the rank's parameters, their layout) of a cell: the
    bytes of the parameter slices (whole for decode), plus two AdamW
    moments in ``opt_state_dtype`` (train) or the rank's rows of the cache
    (decode)."""
    specs = model_specs(cfg)
    params = abstract_params(specs, dtype=torch_dtype(cfg.param_dtype))
    layout = None
    if shape.kind != "decode":
        layout = param_layout(mesh, cfg, specs, overrides)
        if layout is not None:
            params = shard_tree(params, layout.placements, mesh)
    total = _nbytes(params)
    if shape.kind == "train":
        odt = torch_dtype((tcfg or TrainConfig()).opt_state_dtype)
        total += 2 * sum(t.numel() for t in tree_leaves(params)) * odt.itemsize
    elif shape.kind == "decode":
        bspecs, baxes = batch_specs(cfg, shape)
        total += _nbytes(_local(bspecs, baxes, mesh, overrides)["cache"])
    return float(total), params, layout


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh, overrides: Optional[dict] = None,
               tcfg: Optional[TrainConfig] = None) -> dict:
    """One rank's step of a cell on ``mesh`` (an ``AbstractMesh``: meta
    tensors only), counted: ``param_count``, ``flops_total``,
    ``flops_by_op``, ``state_bytes_per_device``, ``collectives``,
    ``trace_s``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.cost import register_flop_formulas

    register_flop_formulas()
    tcfg = tcfg or TrainConfig()
    t0 = time.time()
    result: dict = {"param_count": count_params(model_specs(cfg))}
    result["state_bytes_per_device"], params, layout = cell_state(cfg, shape, mesh,
                                                                  overrides, tcfg)
    bspecs, baxes = batch_specs(cfg, shape)
    before = mesh.traffic()
    with FlopCounterMode(display=False) as counter:
        if shape.kind == "decode":
            local = _local(bspecs, baxes, mesh, overrides)
            result["layout"] = ("whole parameters and cache rows; rows over "
                                f"{_rule_axes(mesh, _merged(overrides), 'cache_batch')}")
            make_serve_step(cfg)(params, local["cache"], local["tokens"])
        else:
            # the rank's rows and sequence slice of the tokens, with their
            # targets; Whisper's frames by the same rows, whole along their
            # own axis; LLaVA's patches by the same rows and the rank's
            # slice of the joint sequence (a (b, p, 0) array stands in for
            # them: the split is host arithmetic on shapes)
            host = {"tokens": np.zeros(tuple(bspecs["tokens"].shape), np.int32)}
            if "patches" in bspecs:
                host["patches"] = np.zeros((*bspecs["patches"].shape[:2], 0), np.float32)
            local = make_global_batch(host, mesh, overrides)
            batch = {k: torch.empty(local[k].shape, dtype=torch.int32, device="meta")
                     for k in ("tokens", "targets")}
            rows = batch["tokens"].shape[0]
            batch.update({k: torch.empty((rows, local[k].shape[1] if k in local else
                                          v.shape[1], *v.shape[2:]), dtype=v.dtype,
                                         device="meta")
                          for k, v in bspecs.items() if k != "tokens"})
            with sharding_rules(mesh, overrides, layout):
                if shape.kind == "train":
                    opt = adamw_init(params)
                    step = make_train_step(cfg, tcfg, warmup_cosine(3e-4, 100, 1000))
                    step(params, opt, batch)
                else:
                    make_prefill_step(cfg)(params, batch)
    result["trace_s"] = round(time.time() - t0, 2)
    counts = counter.get_flop_counts()["Global"]
    result["flops_total"] = float(sum(counts.values()))
    result["flops_by_op"] = {str(k): float(v) for k, v in counts.items()}
    result["collectives"] = collectives_since(mesh, before)
    return result


def run_cell(arch: str, shape_name: str, multi_pod: bool, attention: Optional[str] = None,
             remat: Optional[str] = None, extra_rules: Optional[dict] = None,
             probe: bool = True, cfg_overrides: Optional[dict] = None,
             tcfg: Optional[TrainConfig] = None, *, mesh=None,
             shape: Optional[ShapeConfig] = None) -> dict:
    """One cell (``dryrun.py:150``) on the production mesh (``mesh``: another
    mesh, e.g. a small ``AbstractMesh``; ``shape``: another shape of the
    preset's kind). ``probe`` is taken and not read. Raises where the port
    refuses the cell."""
    cfg = get_config(arch)
    shape = shape or SHAPE_PRESETS[shape_name]
    if attention:
        field = "decode_attention_impl" if shape.kind == "decode" else "attention_impl"
        cfg = dataclasses.replace(cfg, **{field: attention})
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    overrides = dict(extra_rules or {})
    if cfg.num_heads % mesh.shape.get("model", 1) != 0 and shape.kind != "decode":
        # heads that do not divide the TP axis: the sequence over "model"
        overrides.setdefault("seq", "model")
    if shape_name == "long_500k":
        overrides.setdefault("cache_batch", None)
        overrides.setdefault("batch", None)
        overrides.setdefault("cache_seq", tuple(a for a in ("pod", "data", "model")
                                                if a in mesh.shape))
    elif shape.kind == "decode":
        overrides.setdefault("cache_seq", "model")
    cfg = apply_seq_sharding_config(cfg, mesh, overrides)
    result: dict = {"arch": arch, "shape": shape_name,
                    "mesh": "multi" if multi_pod else "single", "devices": mesh.size,
                    "attention": (cfg.decode_attention_impl if shape.kind == "decode"
                                  else cfg.attention_impl), "remat": cfg.remat}
    t0 = time.time()
    _check_supported(cfg, tcfg or TrainConfig(), mesh, overrides)
    result.update(trace_step(cfg, shape, mesh, overrides, tcfg))
    result["total_s"] = round(time.time() - t0, 2)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ["paper-bert"])
    ap.add_argument("--shape", choices=list(SHAPE_PRESETS))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--attention", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for experiment variants")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_IDS if args.all else [args.arch]
    shapes = list(SHAPE_PRESETS) if args.all else [args.shape]
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"__{args.tag}" if args.tag else ""
                path = os.path.join(args.out, f"{arch}__{shape}__{mesh_kind}{tag}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip] {path}")
                    continue
                print(f"[run ] {arch} x {shape} x {mesh_kind} ...", flush=True)
                try:
                    res = run_cell(arch, shape, mesh_kind == "multi",
                                   attention=args.attention, remat=args.remat)
                    res["status"] = "ok"
                except Exception as e:   # written down, as the reference's sweep does
                    res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "error", "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    print(res["error"])
                with open(path, "w") as f:
                    json.dump(res, f, indent=2)
                print(f"[done] {path}: {res['status']} trace={res.get('trace_s')}s "
                      f"flops={res.get('flops_total', 0):.3e}", flush=True)


if __name__ == "__main__":
    main()
