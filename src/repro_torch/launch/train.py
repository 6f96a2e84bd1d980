"""Training launcher: the port's single-device Trainer, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --layers 4 --seq 4096 \\
        --batch 2 --steps 5

trains Qwen2-7B at full width (``--layers`` cuts depth, never width) from
random fp32 master weights (seed 0) on ``SyntheticLM`` batches, with
``attention_impl="spectral_shift_fused"`` (K1/K2 forward, K3/K4 backward)
and ``remat="full"``, and prints the first and last loss, the mean step
time after the first step, tokens/s and the peak device memory
(``--profile``: also the device's busy share of the steps after the first
and its costliest operations, by ``torch.profiler``).
``--reduced --device cpu`` runs the reduced test config on the CPU, where
the kernels' plain versions run instead. The shape is the reference's
``train_4k`` preset, with ``--seq`` and ``--batch`` overriding its sequence
length and global batch. Checkpoints go to ``--ckpt-dir`` (every
``TrainConfig.checkpoint_every`` steps and once at the end) only when it
is given. ``--metrics-out PATH`` writes the per-step metrics history
(loss, ce, grad norm, lr, step time) as JSON, as the reference's
launcher does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import tempfile

import torch

from repro_torch.configs.base import SHAPE_PRESETS, ShapeConfig, TrainConfig, reduced
from repro_torch.configs.registry import get_config
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="shrink to smoke scale (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut depth to this many layers (width is never cut)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0, help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: none is written)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="run the steps after the first under torch.profiler and "
                         "print the device's busy share of that window and its "
                         "costliest operations")
    ap.add_argument("--metrics-out", default="",
                    help="write the per-step metrics history here as JSON")
    args = ap.parse_args(argv)
    if args.profile and args.steps < 2:
        ap.error("--profile needs --steps >= 2 (the first step is not profiled)")

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = get_config("qwen2-7b")
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, attention_impl="spectral_shift_fused")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    preset = SHAPE_PRESETS["train_4k"]
    shape = ShapeConfig(name=preset.name, seq_len=args.seq or preset.seq_len,
                        global_batch=args.batch or preset.global_batch, kind="train")

    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as scratch:
        tcfg = TrainConfig(
            total_steps=max(args.steps, 10), warmup_steps=max(args.steps // 10, 1),
            checkpoint_dir=args.ckpt_dir or scratch,
            checkpoint_every=TrainConfig.checkpoint_every if args.ckpt_dir else 0)
        trainer = Trainer(cfg, tcfg, shape, device=args.device)
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
            history = trainer.run(args.steps)
        if args.ckpt_dir:
            trainer.save(blocking=True)

    first, last = history[0], history[-1]
    later = [h["step_time_s"] for h in history[1:]] or [first["step_time_s"]]
    mean_s = sum(later) / len(later)
    tokens = shape.global_batch * shape.seq_len
    peak = (f"{torch.cuda.max_memory_allocated(trainer.device) / 2**30:.2f} GiB"
            if cuda else "n/a on cpu")
    print(f"[train] {cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"seq={shape.seq_len} batch={shape.global_batch} on {trainer.device}: "
          f"steps={len(history)} loss {first['loss']:.4f} -> {last['loss']:.4f}, "
          f"first step {first['step_time_s']:.3f}s, mean step after it "
          f"{mean_s:.3f}s ({tokens / mean_s:.1f} tokens/s), peak device memory {peak}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=2)
    return history


if __name__ == "__main__":
    main()
