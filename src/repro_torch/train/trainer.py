"""Training loop (``repro/train/trainer.py``), on one device or on the
ranks of a mesh.

    trainer = Trainer(cfg, tcfg, shape)         # init, or restore the latest step
    trainer = Trainer(cfg, tcfg, shape, mesh, rule_overrides={"seq": "model"})
    trainer.run(num_steps)                      # step loop

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
``patches`` (``data/pipeline.py:StubFrontendLM``).

With a ``mesh`` (``distributed/mesh.py``; every rank constructs its Trainer
with the same arguments) the trainer runs under the logical-axis rules
(``distributed/sharding.py``, ``rule_overrides`` as the reference's):
``apply_seq_sharding_config`` first; each step every rank builds the
global batch from the seed and takes its rows and sequence slice
(``make_global_batch``), its loss is its share of the global mean and the
step sums the gradients over the batch's and sequence's axes before the
optimizer (``train/train_step.py``). The dense family's parameters and
both AdamW moments are placed by the parameter rules
(``sharding.param_layout``, the reference's ``shardings_for`` at
``repro/train/trainer.py:115-135``): by default FSDP over "data" and
tensor parallelism over "model", a dimension the axes do not divide left
whole, a mesh axis the sequence claims left out. Every rank builds the
single-device Trainer's full initial tree from ``tcfg.seed`` (or loads the
checkpoint's whole arrays) and keeps its slices (``Trainer.params``);
ranks that hold the same slice are checked to hold the same bytes.
``full_state()`` gathers the whole state on every rank (a collective:
every rank calls it); checkpoints go through it, rank 0 writes whole
arrays, so a checkpoint restores onto any layout or onto one device.
The whole tree is built (or restored) in host memory and only the rank's
slices go to its device. The MoE family trains with the batch split: under
``moe_impl="gspmd"`` each rank routes its own rows (``models/moe.py``,
the aux loss over the whole batch); under ``moe_impl="ep"`` the expert
leaves and their moments split over the expert axes
(``sharding.expert_axes``) and ``moe_forward_ep`` exchanges tokens with
the experts' ranks; the other MoE / MLA leaves stay replicated.
Under a sequence shard attention runs the context-parallel attention
(``kernels/sharded.py``) under ``spectral_shift_fused``, or exact
attention over keys gathered from every shard under ``full`` /
``chunked``, and ``_warm_attention_plans`` resolves the sharded key;
elsewhere its sweep runs at the rank's rows times its query heads. The
hybrid (Hymba) and ssm (xLSTM) families run sequence-parallel too: their
convs, scans and cells take the state the earlier shards carry
(``distributed/seq_parallel.py``). Whisper and LLaVA train under a split
of the batch (each rank takes its rows of ``frames`` / ``patches``,
``make_global_batch``) and of the sequence: Whisper's decoder tokens
split, its encoder whole on every rank; LLaVA's joint sequence [patches,
text] split, a rank's patch rows and text tokens its slice's. Refused
(ROADMAP): an explicit parameter override on the sequence's axis, for a
family other than the dense one (or MoE, MLA), or that the dense layer
cannot run (``sharding.param_rule_conflicts``); MoE under a sequence
shard; the approximate plain impls (``spectral_shift``,
``nystrom``) and the jnp backend under one; ``moe_impl="ep"`` with the
batch's rows split over other axes than the experts'. ``grad_compression``
stays refused (the reference accepts it and reads it nowhere;
``optim/compression.py`` holds the collective).
``opt_state_dtype`` is accepted and, as in the reference's trainer, not
read (only its dry-run reads it). ``lr_fn`` takes the learning-rate
schedule, as the reference's (``repro/train/trainer.py:69``); the default
is ``warmup_cosine`` from ``tcfg``.

Fault tolerance (``repro/train/trainer.py:233-289``): ``monitor=`` (a
``HeartbeatMonitor``; default: hosts ``host{i}`` for i < max(mesh.size //
8, 1), one without a mesh, timeout 600 s) is beaten for every host with
each step's wall time, and stragglers are logged; ``injector=`` (a
``FailureInjector``) names hosts that fail before a step. A failure runs
the elastic restart (``_handle_failure``): rank 0's checkpoint writer is
waited for and the old mesh barriered; host i owns mesh ranks
[i k, (i + 1) k), k = max(mesh.size // hosts, 1); ``ElasticPlan`` gives
the largest (data, model) mesh of the surviving chips with the model
degree kept; the first data x model ranks of the surviving hosts, in
rank order, form the new mesh (``Mesh(ranks=...)``, built on every world
rank; the old mesh's subgroups are destroyed, ``Mesh.close``); the layout and the step function are rebuilt, the latest
checkpoint restored onto the new layout (the step counter goes back to
it; with none, the seed's state at the same step), the slices checked,
the rules re-entered and the attention plan re-resolved. A rank outside
the new mesh frees its state, sets ``active`` false and returns from
``run``. The reference keeps the lowest device ids, whatever host died
(its failure is simulated in one process); the port keeps the surviving
hosts' ranks (ROADMAP, Named differences). ``recoveries`` holds each
restart's seconds: the wait, the new groups, the restore and the slice
check. Without a mesh the one host's failure leaves no chip, and
``ElasticPlan`` raises, as in the reference.

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
versions then run instead); asking for CUDA without a GPU raises. With a
mesh the ranks run on the mesh's device, and a ``device`` that names
another (the default "cuda" beside a CPU mesh) raises.
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLM, make_global_batch, to_device
from repro_torch.distributed.fault_tolerance import (ElasticPlan, FailureInjector,
                                                      HeartbeatMonitor)
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import (Placement, apply_seq_sharding_config,
                                              batch_axes, expert_axes, expert_parallel,
                                              param_layout, param_rule_conflicts,
                                              seq_axes, seq_axis_sharded, sharding_rules)
from repro_torch.kernels import dispatch
from repro_torch.models.attention import SHARD_IMPLS
from repro_torch.models.model import model_specs, torch_dtype
from repro_torch.models.params import (flatten_with_paths, gather_tree, init_params,
                                      map_specs, shard_tree, tree_leaves, tree_map)
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.serve.engine import resolve_device
from repro_torch.telemetry import LATENCY_BUCKETS, ProgramAccounting, Telemetry
from repro_torch.telemetry import accounting
from repro_torch.train.train_step import make_train_step

log = logging.getLogger("repro_torch.trainer")


FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
ATTENTION_IMPLS = ("full", "chunked", "spectral_shift", "nystrom", "spectral_shift_fused")


def _check_supported(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                     overrides: Optional[dict] = None) -> None:
    seq_split = mesh is not None and seq_axis_sharded(mesh, overrides)
    conflicts = param_rule_conflicts(mesh, overrides, cfg) if mesh is not None else []
    moe = f" (MoE, moe_impl {cfg.moe_impl!r})" if cfg.moe else ""
    # expert parallelism routes a rank's rows to the ranks of its experts:
    # the rows must split over the expert axes and nothing else
    def spread(axes):
        return tuple(a for a in axes if mesh.shape[a] > 1)

    ep_rows = (mesh is not None and expert_parallel(cfg)
               and spread(batch_axes(mesh, overrides)) != spread(expert_axes(mesh)))
    attention_free = cfg.family == "ssm" and cfg.attention_impl == "none"
    unsupported = {
        f"parameter sharding ({', '.join(conflicts)})": bool(conflicts),
        f"family {cfg.family!r}{moe} under a sequence shard": seq_split and cfg.moe,
        f"attention {cfg.attention_impl!r} / backend {cfg.attention_backend!r} under a "
        f"sequence shard (the fused kernels' context-parallel attention, or exact "
        f"attention over gathered keys)": (
            seq_split and not attention_free and (
                cfg.attention_impl not in SHARD_IMPLS
                or (cfg.attention_impl == "spectral_shift_fused"
                    and cfg.attention_backend == "jnp"))),
        f"moe_impl 'ep' with the batch over {batch_axes(mesh, overrides) if mesh else ()}, "
        f"not the expert axes {expert_axes(mesh) if mesh else ()}": ep_rows and not seq_split,
        f"family {cfg.family!r}": cfg.family not in FAMILIES,
        f"attention_impl {cfg.attention_impl!r}": (
            cfg.attention_impl not in ATTENTION_IMPLS and not attention_free),
        f"encoder_attention_impl {cfg.encoder_attention_impl!r}": (
            cfg.family == "audio" and cfg.encoder_attention_impl not in ATTENTION_IMPLS),
        "grad_compression": tcfg.grad_compression is not None,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, shape: ShapeConfig,
                 mesh=None, *, rule_overrides: Optional[dict] = None, device="cuda",
                 telemetry: Optional[Telemetry] = None, data=None,
                 lr_fn: Optional[Callable] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 injector: Optional[FailureInjector] = None):
        self.mesh = mesh
        self.rule_overrides = dict(rule_overrides or {})
        if mesh is not None:
            cfg = apply_seq_sharding_config(cfg, mesh, self.rule_overrides, log=log)
        _check_supported(cfg, tcfg, mesh, self.rule_overrides)
        if mesh is not None:
            # the mesh's device is the rank's (its GPU index); ``device`` may
            # leave the index out, never name another device
            want = torch.device(device)
            if want.type != mesh.device.type or want.index not in (None, mesh.device.index):
                raise ValueError(f"Trainer: device {want} but the mesh's ranks run on "
                                 f"{mesh.device}; pass the mesh's device")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.cfg, self.tcfg, self.shape = cfg, tcfg, shape
        self.telemetry = telemetry if telemetry is not None else Telemetry(enabled=False)
        self.data = data or SyntheticLM(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                                        global_batch=shape.global_batch, seed=tcfg.seed)
        self.ckpt = Checkpointer(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
        self.lr_fn = lr_fn or warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps,
                                            tcfg.total_steps)
        if self.telemetry.enabled:
            r = self.telemetry.metrics
            dispatch.set_metrics(r)
            self.telemetry.stamp_provenance(cfg, tcfg, device=self.device)
            accounting.set_metrics(r)
            self._step_hist = r.histogram("train_step_seconds",
                                          help="wall time per optimizer step",
                                          buckets=LATENCY_BUCKETS)
            self._gauges = {name: r.gauge(f"train_{name}", help=f"last step's {name}")
                            for name in ("loss", "ce", "grad_norm", "lr")}
        self.injector = injector
        hosts = [f"host{i}" for i in range(max(mesh.size // 8, 1) if mesh is not None else 1)]
        self.monitor = monitor or HeartbeatMonitor(hosts, timeout_s=600.0)
        self.active = True
        self.recoveries: list[dict] = []
        self.step = 0
        self.metrics_history: list[dict] = []
        self._build_step()
        self._init_or_restore()
        if mesh is not None:
            self._check_slices()
        self.plan = self._warm_attention_plans()

    def _build_step(self) -> None:
        """The parameter layout of the mesh and the step function."""
        cfg = self.cfg
        self.layout = (param_layout(self.mesh, cfg, model_specs(cfg), self.rule_overrides)
                       if self.mesh is not None else None)
        self.step_fn = make_train_step(cfg, self.tcfg, self.lr_fn)
        if self.telemetry.enabled:
            self.step_fn = ProgramAccounting(self.telemetry.metrics).wrap(self.step_fn,
                                                                          "train_step")

    def _rules(self):
        """The logical-axis rules' context for the step loop (none without
        a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharding_rules(self.mesh, self.rule_overrides, self.layout)

    def _state_placements(self):
        """The placements of ``state()``'s leaves (the moments' are their
        parameters'; the step is whole)."""
        places = self.layout.placements
        return {"params": places, "opt": AdamWState(step=Placement(()), m=places, v=places)}

    def _check_slices(self) -> None:
        """Raise unless the ranks that hold the same slice of a parameter
        hold the same bytes (a digest per leaf and slice, gathered; with
        whole parameters, every rank's). The moments start as zeros or come
        from the same checkpoint file."""
        import torch.distributed as dist

        mine = {}
        places = (tree_leaves(self.layout.placements) if self.layout is not None
                  else [Placement(())] * len(tree_leaves(self.params)))
        for (path, t), pl in zip(flatten_with_paths(self.params).items(), places):
            where = tuple(self.mesh.index(axes) for axes in pl.dims)
            data = t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
            mine[(path, where)] = hashlib.sha256(data).hexdigest()
        every = [None] * self.mesh.size
        dist.all_gather_object(every, mine, group=self.mesh.group(self.mesh.axis_names))
        seen: dict = {}
        for rank, digests in enumerate(every):
            for key, digest in digests.items():
                if seen.setdefault(key, digest) != digest:
                    raise RuntimeError(f"Trainer: rank {rank} holds other bytes than a "
                                       f"rank with the same slice of {key[0]} after init")

    def _warm_attention_plans(self) -> Optional[dispatch.Plan]:
        """Resolve the train shape's attention plan before the first step
        (``trainer.py:177``): memory or the disk cache (``autotune_cache``
        moves it), else a measured sweep at the train shape (batch x heads
        batch-heads, compute dtype; K1-K4, forward and backward, on the
        card), registered and saved. Only with
        ``autotune=True`` under ``spectral_shift_fused`` and backend "auto"
        (a forced backend never reads the registry). Returns the plan."""
        cfg = self.cfg
        if (self.mesh is not None and seq_axis_sharded(self.mesh, self.rule_overrides)
                and cfg.attention_impl == "spectral_shift_fused"
                and cfg.attention_backend == "auto"):
            # the sharded key: its heuristic or a registered plan, never a
            # sweep (``get_plan``; a single-rank sweep cannot reproduce it)
            shards = self.mesh.axis_size(seq_axes(self.mesh, self.rule_overrides))
            key = dispatch.make_key(self.shape.seq_len, cfg.num_landmarks,
                                    cfg.resolved_head_dim, cfg.compute_dtype,
                                    cfg.is_decoder_only, backend=self.device.type,
                                    seq_shards=shards)
            with self.telemetry.span("plan_resolution", n=key.n):
                plan = dispatch.get_plan(key, autotune_enabled=cfg.autotune)
            log.info("attention plan for n=%d over %d sequence shards (%s): impl=%s "
                     "block_n=%d", self.shape.seq_len, shards, plan.source, plan.impl,
                     plan.block_n)
            return plan
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
                    backend=key.backend, backward=True, batch=self._attention_batch())
        log.info("attention plan for n=%d (%s): impl=%s block_n=%d",
                 self.shape.seq_len, plan.source, plan.impl, plan.block_n)
        return plan

    def _attention_batch(self) -> int:
        """Batch-heads of one attention call on this rank: its rows times
        its query heads."""
        rows = self.shape.global_batch
        heads = self.cfg.num_heads
        if self.mesh is not None:
            rows //= self.mesh.axis_size(batch_axes(self.mesh, self.rule_overrides))
        if self.layout is not None and self.layout.tp.heads:
            heads //= self.mesh.axis_size(self.layout.tp.heads)
        return rows * heads

    def _init_or_restore(self) -> None:
        """The state from the latest checkpoint's whole arrays (the step
        counter goes back to it), else the single-device initial tree from
        ``tcfg.seed`` (the counter stays); under a parameter
        layout the whole tree is built in host memory (drawn on the
        device's generator, so the weights are the single device's) and
        every rank moves only its slices to the device."""
        specs = model_specs(self.cfg)
        latest = self.ckpt.latest_step()
        host = torch.device("cpu") if self.layout is not None else self.device
        if latest is not None:
            log.info("restoring step %d", latest)
            skel = map_specs(lambda _path, _spec: None, specs)
            state = self.ckpt.restore(latest, {"params": skel, "opt": AdamWState(
                step=None, m=skel, v=skel)}, device=host)
            if self.layout is not None:
                state = shard_tree(state, self._state_placements(), self.mesh)
                state = tree_map(lambda t: t.to(self.device), state)
            self.step = latest
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
            params = init_params(specs, gen, dtype=torch_dtype(self.cfg.param_dtype),
                                 device=host)
            if self.layout is not None:
                params = tree_map(lambda t: t.to(self.device),
                                  shard_tree(params, self.layout.placements, self.mesh))
            state = {"params": params, "opt": adamw_init(params)}
        self.params, self.opt_state = state["params"], state["opt"]

    def state(self) -> dict:
        """The rank's state: ``{"params": ..., "opt": AdamWState}``, slices
        under a parameter layout."""
        return {"params": self.params, "opt": self.opt_state}

    def full_state(self, device=None) -> dict:
        """The whole state, what a checkpoint holds, on every rank: under a
        parameter layout each leaf's slices all-gathered (a collective:
        every rank calls it), each whole leaf moved to ``device`` as soon
        as it is gathered (default: the rank's); else ``state()`` itself."""
        if self.layout is None:
            return self.state()
        return gather_tree(self.state(), self._state_placements(), self.mesh, device=device)

    def save(self, blocking: bool = False) -> None:
        """Checkpoint the whole state: every rank gathers it (on its main
        thread), rank 0 writes (``blocking=False``: on its writer thread)."""
        state = self.full_state(device="cpu")
        if self.mesh is None or self.mesh.rank == 0:
            self.ckpt.save(self.step, state, blocking=blocking)

    def _batch(self, step: int) -> dict:
        host = self.data.batch(step)
        if self.mesh is not None:
            host = make_global_batch(host, self.mesh, self.rule_overrides)
        return to_device(host, self.device)

    def _handle_failure(self, dead: list[str]) -> None:
        """The elastic restart (``repro/train/trainer.py:233-252``): re-plan
        the mesh over the surviving hosts' ranks, rebuild the layout and the
        step, restore the latest checkpoint onto it. A rank outside the new
        mesh frees its state and turns inactive."""
        log.warning("step %d: hosts failed: %s; elastic restart", self.step, dead)
        t0 = time.perf_counter()
        self.ckpt.wait()
        old = self.mesh
        if old is not None:
            old.barrier()   # rank 0's checkpoint is complete for every rank
        t_wait = time.perf_counter()
        hosts = list(self.monitor.hosts)
        size = old.size if old is not None else 1
        k = max(size // len(hosts), 1)
        alive = [r for i, h in enumerate(hosts) if h not in dead
                 for r in range(i * k, min((i + 1) * k, size))]
        shape = old.shape if old is not None else {}
        plan = ElasticPlan.plan(len(alive), shape.get("model", 1),
                                max_data=shape.get("data", 1))
        if old is None:   # one device survives: the latest checkpoint, restored
            self._init_or_restore()
            return
        keep = [old.ranks[r] for r in alive[:plan.data * plan.model]]
        log.warning("re-planned onto a %d x %d mesh over world ranks %s (%d chips dropped)",
                    plan.data, plan.model, keep, plan.dropped_chips)
        self.mesh = Mesh((plan.data, plan.model), ("data", "model"), ranks=keep,
                         device=old.device, timeout_s=old.timeout_s)
        old.close()
        for h in dead:
            del self.monitor.hosts[h]
        t_groups = time.perf_counter()
        self.params = self.opt_state = None
        record = {"step": self.step, "wait_s": t_wait - t0, "groups_s": t_groups - t_wait,
                  "member": self.mesh.member, "mesh": dict(self.mesh.shape), "ranks": keep}
        self.recoveries.append(record)
        if not self.mesh.member:
            self.layout, self.step_fn, self.active = None, None, False
            return
        self._build_step()
        self._init_or_restore()
        t_restore = time.perf_counter()
        self._check_slices()
        t_check = time.perf_counter()
        self.plan = self._warm_attention_plans()
        record.update(step=self.step, restore_s=t_restore - t_groups,
                      check_s=t_check - t_restore)

    def run(self, num_steps: int, log_every: int = 10) -> list[dict]:
        """Run up to ``num_steps`` steps (fewer if an elastic restart leaves
        this rank outside the mesh); returns the history so far."""
        end = self.step + num_steps
        with contextlib.ExitStack() as rules:
            rules.enter_context(self._rules())
            while self.active and self.step < end:
                dead = self.injector.failures_at(self.step) if self.injector else []
                if dead:
                    rules.close()   # the rules are process-wide: re-entered on the new mesh
                    self._handle_failure(dead)
                    if not self.active:
                        break
                    rules.enter_context(self._rules())
                t0 = time.perf_counter()
                with self.telemetry.step_span("train_step", self.step):
                    batch = self._batch(self.step)
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
                for h in self.monitor.hosts:
                    self.monitor.beat(h, dt)
                stragglers = self.monitor.stragglers()
                if stragglers:
                    log.warning("stragglers detected: %s", stragglers)
                self.step += 1
                if self.tcfg.checkpoint_every and self.step % self.tcfg.checkpoint_every == 0:
                    self.save(blocking=False)
                if self.step % log_every == 0 or self.step == end:
                    log.info("step %d loss=%.4f ce=%.4f %.2fs", self.step,
                             metrics.get("loss", float("nan")),
                             metrics.get("ce", float("nan")), dt)
        self.ckpt.wait()
        if self.mesh is not None and self.active:
            self.mesh.barrier()   # rank 0's checkpoints are complete for every rank
        return self.metrics_history
