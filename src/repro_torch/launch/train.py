"""Training launcher: the port's Trainer, on the card, on one device or on
local ranks over a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --layers 4 --seq 4096 \\
        --batch 2 --steps 5 --attention spectral_shift_fused
    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-bert \\
        --attention spectral_shift_fused --autotune
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --seq 4096 --batch 2 --steps 3 --attention spectral_shift_fused
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-lite-16b --layers 4 --seq 4096 --batch 1 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \\
        --seq 4096 --batch 4 --steps 3 --encoder-attention spectral_shift_fused
    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-bert \\
        --attention spectral_shift_fused --seq 8192 --batch 4 --steps 3 \\
        --nproc 4 --mesh 2x2 --seq-axis model
    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-bert \\
        --attention spectral_shift_fused --seq 4096 --batch 8 --steps 3 \\
        --nproc 4 --model-parallel 2

trains ``--arch`` (qwen2-7b by default; paper-bert, the paper's own
setting; the ``moe`` configs deepseek-v2-lite-16b, whose MLA runs no
kernel under any impl as in the reference, and kimi-k2-1t-a32b, which fits
no single card at full width and runs with ``--reduced``; the hybrid
hymba-1.5b; xlstm-350m, attention-free, no kernel; whisper-base, whose
batches carry seeded stub frame embeddings (1500 frames) and whose
encoder runs ``--encoder-attention``, bidirectional, the config's own
``spectral_shift`` by default; llava-next-34b, whose batches carry seeded
stub patch features, min(2880, seq / 2) of them ahead of the tokens:
``data/pipeline.py:StubFrontendLM``) at full width (``--layers`` cuts depth, never width) from random
fp32 master weights (seed 0) on ``SyntheticLM`` batches, with the
config's own ``attention_impl`` or ``--attention`` (``spectral_shift_fused``:
K1/K2 forward, K3/K4 backward) and ``remat="full"``, at learning rate
``--lr``, and prints the first and last loss, the mean step time after the
first step, tokens/s and the peak device memory (``--profile``: also the
device's busy share of the steps after the first and its costliest
operations, by ``torch.profiler``). ``--autotune`` measures the kernels'
tiling at the train shape before the first step (``Trainer.
_warm_attention_plans``) and keeps the winner in the autotune cache
(``--autotune-cache PATH``, else ``REPRO_AUTOTUNE_CACHE`` or
``~/.cache/repro/ss_autotune.json``), which later runs read instead.
``--reduced --device cpu`` runs the reduced test config on the CPU, where
the kernels' plain versions run instead. The shape is the reference's
``--shape`` preset (``train_4k``), with ``--seq`` and ``--batch``
overriding its sequence length and global batch. Checkpoints go to ``--ckpt-dir`` (every
``TrainConfig.checkpoint_every`` steps and once at the end) only when it
is given. ``--metrics-out PATH`` writes the per-step metrics history
(loss, ce, grad norm, lr, step time) as JSON, as the reference's
launcher does.

``--nproc N --mesh DxM`` spawns N local ranks (``launch/mesh.py:
spawn_local``) over a ("data", "model") mesh of D x M and trains under
the default rules: data-parallel over "data", the dense family's
parameters and moments FSDP over "data" and tensor-parallel over "model"
(``distributed/sharding.py:param_layout``). ``--model-parallel M`` is the
reference's flag: the mesh of ``make_local_mesh(M)``, (N / M) x M, and
stands instead of ``--mesh``. With ``--seq-axis model`` (the rule
override ``{"seq": "model"}``) the sequence splits over "model", attention
through the context-parallel attention (``kernels/sharded.py``), and the
parameters stay whole over the sequence's axis. Ranks take
GPU rank mod the GPU count and run gloo when they share a card (NCCL
will not put two ranks of one communicator on one GPU) or run on the
CPU, nccl when each owns one. Only the launching process
prints: rank 0's losses and times, every rank's peak memory and the share
of rank 0's steps spent in collectives.

``--fail-at N`` injects the reference's simulated failure of ``host0``
before step N (``FailureInjector``) under the Trainer's default monitor:
hosts of 8 ranks. Below 16 ranks there is one host, its failure leaves
no chip and ``ElasticPlan`` raises ("cannot keep TP=..."), as the
reference's launcher does on its one-host local mesh; from 16 ranks the
Trainer restarts on the surviving hosts' ranks.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import tempfile
import time

import torch

from repro_torch.configs.base import SHAPE_PRESETS, ShapeConfig, TrainConfig, reduced
from repro_torch.configs.registry import ARCH_IDS, ENCODER_SEQ, get_config
from repro_torch.data.pipeline import StubFrontendLM
from repro_torch.distributed.fault_tolerance import FailureInjector
from repro_torch.models.params import tree_leaves
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCH_IDS + ["paper-bert"])
    ap.add_argument("--shape", default="train_4k",
                    choices=[n for n, p in SHAPE_PRESETS.items() if p.kind == "train"])
    ap.add_argument("--reduced", action="store_true",
                    help="shrink to smoke scale (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (width is never cut)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0, help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--attention", default=None,
                    help="override training attention impl")
    ap.add_argument("--encoder-attention", default=None,
                    help="override whisper's encoder attention impl")
    ap.add_argument("--autotune", action="store_true",
                    help="measure the attention kernels' tiling at the train shape "
                         "(ModelConfig.autotune)")
    ap.add_argument("--autotune-cache", default="",
                    help="autotune cache file (ModelConfig.autotune_cache)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: none is written)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="run the steps after the first under torch.profiler and "
                         "print the device's busy share of that window and its "
                         "costliest operations")
    ap.add_argument("--metrics-out", default="",
                    help="write the per-step metrics history here as JSON")
    ap.add_argument("--nproc", type=int, default=1,
                    help="local ranks to spawn (1: no mesh)")
    ap.add_argument("--mesh", default=None, type=_mesh_shape,
                    help="DxM: the (data, model) mesh of the ranks (default Nx1)")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="M: the reference's make_local_mesh(M) layout, (nproc / M) x M "
                         "(instead of --mesh)")
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a simulated host failure at this step: "
                         "FailureInjector({N: ['host0']}) with the Trainer's default "
                         "monitor (hosts of 8 ranks, one below 16 ranks, whose failure "
                         "leaves no chip, so ElasticPlan raises, as the reference's "
                         "launcher does on its one-host local mesh)")
    ap.add_argument("--seq-axis", default="", choices=["", "data", "model"],
                    help="shard the sequence over this mesh axis (rule override "
                         "{'seq': AXIS})")
    args = ap.parse_args(argv)
    if args.profile and args.steps < 2:
        ap.error("--profile needs --steps >= 2 (the first step is not profiled)")
    if args.model_parallel:
        if args.mesh:
            ap.error("--model-parallel and --mesh both set the mesh: give one")
        if args.nproc % args.model_parallel:
            ap.error(f"--nproc {args.nproc} does not split into model axes of "
                     f"{args.model_parallel}")
        args.mesh = (args.nproc // args.model_parallel, args.model_parallel)
    if args.nproc > 1 or args.mesh:
        if args.profile:
            ap.error("--profile runs on one device (no --nproc)")
        mesh_shape = args.mesh or (args.nproc, 1)
        if mesh_shape[0] * mesh_shape[1] != args.nproc:
            ap.error(f"--mesh {mesh_shape[0]}x{mesh_shape[1]} must have D * M = --nproc "
                     f"{args.nproc}")
        return _spawn(args, mesh_shape)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    history, lines = _train(args)
    for line in lines:
        print(line)
    return history


def _mesh_shape(text: str) -> tuple:
    parts = text.split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise argparse.ArgumentTypeError(f"{text!r} is not DxM (e.g. 2x2)")
    return int(parts[0]), int(parts[1])


def _spawn(args, mesh_shape):
    from repro_torch.launch.mesh import spawn_local

    share = args.device == "cpu" or torch.cuda.device_count() < args.nproc
    backend = "gloo" if share else "nccl"
    if args.device != "cpu":
        from repro_torch.kernels import build

        build.build()   # once, before the ranks: they load the built libraries
    results = spawn_local(_rank_train, mesh_shape, ("data", "model"), args=(args,),
                          backend=backend, device="cpu" if args.device == "cpu" else "cuda",
                          timeout_s=1800.0)
    history, lines, _ = results[0]
    peaks = [r[2] for r in results]
    for line in lines:
        print(line)
    if peaks[0] is not None:
        print(f"[train] mesh {mesh_shape[0]}x{mesh_shape[1]} ({backend}): peak device "
              f"memory per rank " + ", ".join(f"{p:.2f}" for p in peaks) + " GiB")
    return history


def _rank_train(mesh, args):
    """One rank of a ``--nproc`` run: (history, rank 0's lines, peak GiB)."""
    logging.basicConfig(level=logging.INFO if mesh.rank == 0 else logging.WARNING,
                        format=f"%(asctime)s [rank {mesh.rank}] %(message)s")
    overrides = {"seq": args.seq_axis} if args.seq_axis else {}
    history, lines = _train(args, mesh, overrides)
    cuda = mesh.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(mesh.device) / 2**30 if cuda else None
    return history, lines, peak


def _train(args, mesh=None, overrides=None):
    """Build the config, shape and Trainer from the flags and run it.
    Returns (history, the summary lines)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.attention:
        cfg = dataclasses.replace(cfg, attention_impl=args.attention)
    if args.encoder_attention:
        cfg = dataclasses.replace(cfg, encoder_attention_impl=args.encoder_attention)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    cfg = dataclasses.replace(cfg, autotune=args.autotune,
                              autotune_cache=args.autotune_cache)
    preset = SHAPE_PRESETS[args.shape]
    shape = ShapeConfig(name=preset.name, seq_len=args.seq or preset.seq_len,
                        global_batch=args.batch or preset.global_batch, kind="train")

    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as scratch:
        tcfg = TrainConfig(
            learning_rate=args.lr, total_steps=max(args.steps, 10), warmup_steps=max(args.steps // 10, 1),
            checkpoint_dir=args.ckpt_dir or scratch,
            checkpoint_every=TrainConfig.checkpoint_every if args.ckpt_dir else 0)
        data = None
        if cfg.family in ("audio", "vlm"):
            data = StubFrontendLM(cfg.family, cfg.vocab_size, shape.seq_len,
                                  shape.global_batch, d_model=cfg.d_model,
                                  num_patches=cfg.num_patches,
                                  enc_len=ENCODER_SEQ, seed=tcfg.seed)
        injector = FailureInjector({args.fail_at: ["host0"]}) if args.fail_at else None
        trainer = Trainer(cfg, tcfg, shape, mesh, rule_overrides=overrides,
                          device=args.device, data=data, injector=injector)
        cuda = trainer.device.type == "cuda"
        if cuda:
            from repro_torch.kernels import build

            build.build()  # compile every kernel before the first step is timed
            torch.cuda.reset_peak_memory_stats(trainer.device)
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            from repro_torch.launch.serve import profile_top

            trainer.run(1)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                history = trainer.run(args.steps - 1)
            wall = sum(h["step_time_s"] for h in history[1:])
            print(f"[train] profile of steps 1..{args.steps - 1}: {profile_top(prof, wall)}")
        else:
            t_run = time.perf_counter()
            coll0 = mesh.collective_seconds if mesh is not None else 0.0
            history = trainer.run(args.steps)
            t_run = time.perf_counter() - t_run
        if args.ckpt_dir:
            trainer.save(blocking=True)

    first, last = history[0], history[-1]
    later = [h["step_time_s"] for h in history[1:]] or [first["step_time_s"]]
    mean_s = sum(later) / len(later)
    tokens = shape.global_batch * shape.seq_len
    peak = (f"{torch.cuda.max_memory_allocated(trainer.device) / 2**30:.2f} GiB"
            if cuda else "n/a on cpu")
    lines = []
    plan = trainer.plan
    if plan is not None:
        lines.append(f"[train] attention plan: {plan.impl} block_n={plan.block_n} "
                     f"({plan.source})")
    where = str(trainer.device) if mesh is None else f"{mesh.size} ranks {mesh.shape}"
    lines.append(f"[train] {cfg.name} {cfg.attention_impl} layers={cfg.num_layers} "
                 f"d_model={cfg.d_model} "
                 f"seq={shape.seq_len} batch={shape.global_batch} on {where}: "
                 f"steps={len(history)} loss {first['loss']:.4f} -> {last['loss']:.4f}, "
                 f"first step {first['step_time_s']:.3f}s, mean step after it "
                 f"{mean_s:.3f}s ({tokens / mean_s:.1f} tokens/s), peak device memory "
                 f"{peak}")
    if trainer.layout is not None:
        tp = trainer.layout.tp
        fsdp = sorted({a for p in tree_leaves(trainer.layout.placements) for a in p.gathered})
        lines.append(f"[train] parameters and moments placed by the rules: heads over "
                     f"{tp.heads}, kv heads over {tp.kv_heads}, ff over {tp.ff}, vocab "
                     f"over {tp.vocab}, FSDP over {tuple(fsdp)}")
    if mesh is not None and not args.profile:
        share = (mesh.collective_seconds - coll0) / t_run
        lines.append(f"[train] collectives: {100 * share:.1f}% of rank 0's steps "
                     f"({mesh.backend}; CUDA operands staged through the host under gloo)")
    if args.metrics_out and (mesh is None or mesh.rank == 0):
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=2)
    return history, lines


if __name__ == "__main__":
    main()
