"""Single-device training loop (``repro/train/trainer.py``).

    trainer = Trainer(cfg, tcfg, shape)   # init, or restore the latest step
    trainer.run(num_steps)                # step loop

Per step: build the batch for the step counter, place it on the device,
run the train step (K1/K2 forward, K3/K4 backward on the card), record
the metrics and ``step_time_s``; every ``checkpoint_every`` steps a
threaded checkpoint is published atomically. Before the first step
``_warm_attention_plans`` resolves the attention plan of the train shape
(``repro/train/trainer.py:177``): with ``autotune=True`` under
``spectral_shift_fused`` and backend "auto", from memory or the cache
(``autotune_cache`` moves it) or else by a measured sweep at the train
shape. It trains every family: dense, ``moe`` (GQA or MLA attention, MoE
feed-forward with its load-balance loss), ``hybrid`` (Hymba), ``ssm``
(xLSTM), ``audio`` (Whisper) and ``vlm`` (LLaVA). ``data=`` takes the
batches (``batch(step) -> dict`` of numpy arrays), as the reference's
``data=`` (``repro/train/trainer.py:97``); the default is ``SyntheticLM``,
tokens only, so Whisper and LLaVA need a source with ``frames`` /
``patches`` (``data/pipeline.py:StubFrontendLM``). The reference's mesh,
shardings, elastic re-planning, heartbeats, failure injection,
``grad_compression`` and the expert-parallel ``moe_impl="ep"`` are not
ported; settings that need them raise. ``opt_state_dtype``
is accepted and, as in the reference's trainer, not read (only its dry-run
reads it).

``telemetry=`` takes a caller-owned ``Telemetry`` (``repro/train/
trainer.py:70-92``): each step runs in a ``step_span("train_step",
step)``, its wall time goes to ``train_step_seconds`` and the last
step's loss, ce, grad norm and lr to the gauges ``train_loss``,
``train_ce``, ``train_grad_norm`` and ``train_lr``; the step program is
under program accounting (``program_shapes_total{program="train_step"}``),
the run's configs are stamped into the provenance, plan resolution counts
into ``autotune_plan_resolutions_total`` and runs in a ``plan_resolution``
span. Without one the no-op bundle stands in.

Runs on CUDA unless the caller passes ``device="cpu"`` (the kernels' plain
versions then run instead); asking for CUDA without a GPU raises.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.kernels import dispatch
from repro_torch.models.model import model_specs, torch_dtype
from repro_torch.models.params import init_params, map_specs
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.serve.engine import resolve_device
from repro_torch.telemetry import LATENCY_BUCKETS, ProgramAccounting, Telemetry
from repro_torch.telemetry import accounting
from repro_torch.train.train_step import make_train_step

log = logging.getLogger("repro_torch.trainer")


FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
ATTENTION_IMPLS = ("full", "chunked", "spectral_shift", "nystrom", "spectral_shift_fused")


def _check_supported(cfg: ModelConfig, tcfg: TrainConfig) -> None:
    unsupported = {
        f"family {cfg.family!r}": cfg.family not in FAMILIES,
        "moe_impl 'ep' (expert parallel, multi-device)": cfg.moe and cfg.moe_impl == "ep",
        f"attention_impl {cfg.attention_impl!r}": cfg.attention_impl not in ATTENTION_IMPLS
            and not (cfg.family == "ssm" and cfg.attention_impl == "none"),
        f"encoder_attention_impl {cfg.encoder_attention_impl!r}": (
            cfg.family == "audio" and cfg.encoder_attention_impl not in ATTENTION_IMPLS),
        "grad_compression": tcfg.grad_compression is not None,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, shape: ShapeConfig,
                 *, device="cuda", telemetry: Optional[Telemetry] = None, data=None):
        _check_supported(cfg, tcfg)
        self.device = resolve_device(device)
        self.cfg, self.tcfg, self.shape = cfg, tcfg, shape
        self.telemetry = telemetry if telemetry is not None else Telemetry(enabled=False)
        self.data = data or SyntheticLM(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                                        global_batch=shape.global_batch, seed=tcfg.seed)
        self.ckpt = Checkpointer(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
        self.step_fn = make_train_step(cfg, tcfg, warmup_cosine(
            tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps))
        if self.telemetry.enabled:
            r = self.telemetry.metrics
            dispatch.set_metrics(r)
            self.telemetry.stamp_provenance(cfg, tcfg, device=self.device)
            accounting.set_metrics(r)
            self.step_fn = ProgramAccounting(r).wrap(self.step_fn, "train_step")
            self._step_hist = r.histogram("train_step_seconds",
                                          help="wall time per optimizer step",
                                          buckets=LATENCY_BUCKETS)
            self._gauges = {name: r.gauge(f"train_{name}", help=f"last step's {name}")
                            for name in ("loss", "ce", "grad_norm", "lr")}
        self.step = 0
        self.metrics_history: list[dict] = []
        self._init_or_restore()
        self.plan = self._warm_attention_plans()

    def _warm_attention_plans(self) -> Optional[dispatch.Plan]:
        """Resolve the train shape's attention plan before the first step
        (``trainer.py:177``): memory or the disk cache (``autotune_cache``
        moves it), else a measured sweep at the train shape (batch x heads
        batch-heads, compute dtype; K1-K4, forward and backward, on the
        card), registered and saved. Only with
        ``autotune=True`` under ``spectral_shift_fused`` and backend "auto"
        (a forced backend never reads the registry). Returns the plan."""
        cfg = self.cfg
        if (not cfg.autotune or cfg.attention_impl != "spectral_shift_fused"
                or cfg.attention_backend != "auto"):
            return None
        if cfg.autotune_cache:
            dispatch.set_cache_path(cfg.autotune_cache)
            dispatch.load_cache()
        key = dispatch.make_key(self.shape.seq_len, cfg.num_landmarks,
                                cfg.resolved_head_dim, cfg.compute_dtype,
                                cfg.is_decoder_only, backend=self.device.type)
        with self.telemetry.span("plan_resolution", n=key.n):
            plan = dispatch.get_plan(key)
            if plan.source == "heuristic":  # nothing measured for this shape
                plan = dispatch.autotune(
                    self.shape.seq_len, cfg.num_landmarks, cfg.resolved_head_dim,
                    dtype=cfg.compute_dtype, causal=cfg.is_decoder_only,
                    backend=key.backend, backward=True,
                    batch=self.shape.global_batch * cfg.num_heads)
        log.info("attention plan for n=%d (%s): impl=%s block_n=%d",
                 self.shape.seq_len, plan.source, plan.impl, plan.block_n)
        return plan

    def _init_or_restore(self) -> None:
        specs = model_specs(self.cfg)
        latest = self.ckpt.latest_step()
        if latest is not None:
            log.info("restoring step %d", latest)
            skel = map_specs(lambda _path, _spec: None, specs)
            state = self.ckpt.restore(latest, {"params": skel, "opt": AdamWState(
                step=None, m=skel, v=skel)}, device=self.device)
            self.params, self.opt_state = state["params"], state["opt"]
            self.step = latest
            return
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.params = init_params(specs, gen, dtype=torch_dtype(self.cfg.param_dtype),
                                  device=self.device)
        self.opt_state = adamw_init(self.params)

    def state(self) -> dict:
        """What a checkpoint holds: ``{"params": ..., "opt": AdamWState}``."""
        return {"params": self.params, "opt": self.opt_state}

    def save(self, blocking: bool = False) -> None:
        self.ckpt.save(self.step, self.state(), blocking=blocking)

    def run(self, num_steps: int, log_every: int = 10) -> list[dict]:
        end = self.step + num_steps
        while self.step < end:
            t0 = time.perf_counter()
            with self.telemetry.step_span("train_step", self.step):
                batch = to_device(self.data.batch(self.step), self.device)
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                # float() waits for the step's device work to finish
                metrics = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
            dt = time.perf_counter() - t0
            metrics["step"] = self.step
            metrics["step_time_s"] = dt
            self.metrics_history.append(metrics)
            if self.telemetry.enabled:
                self._step_hist.observe(dt)
                for name, g in self._gauges.items():
                    if name in metrics:
                        g.set(metrics[name])
            self.step += 1
            if self.tcfg.checkpoint_every and self.step % self.tcfg.checkpoint_every == 0:
                self.save(blocking=False)
            if self.step % log_every == 0 or self.step == end:
                log.info("step %d loss=%.4f ce=%.4f %.2fs", self.step,
                         metrics.get("loss", float("nan")),
                         metrics.get("ce", float("nan")), dt)
        self.ckpt.wait()
        return self.metrics_history
