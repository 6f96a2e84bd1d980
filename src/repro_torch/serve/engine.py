"""Serving engine: paged KV cache + two-phase scheduler over spectral-shift
decode (``repro/serve/engine.py``, the two-phase tick ``_tick_inner``).

It serves every family of the reference's engine, one cache layout per
family (``serve/kv_cache.py``): dense and ``vlm`` (LLaVA's decoder; text
prompts only, as the reference's engine), ``moe`` (GQA or absorbed MLA
attention with an MoE feed-forward: DeepSeek-V2-Lite), ``hybrid`` (Hymba:
GQA and a mamba SSM in parallel), ``ssm`` (xLSTM: no attention, no
sequence-shaped leaf, so its storage is lane-dense with no allocator:
``stats()["mode"]`` ``dense+...`` and no ``"kv"``) and ``audio``
(Whisper's decoder, served without an encoder pass: its cross K/V stay
zero, as the reference's). A family without batched prefill
(``prefill.prefill_supported``: hybrid, ssm, audio) prefills by token
replay, one prompt token a tick through the decode step from zeroed lane
state, and the chunked tick and the prefix cache are silently off for it
(``engine.py:180-197``, ``:328``), as in the reference; ``stats()["mode"]``
then says ``+replay-prefill``.

Each tick admits waiting requests FCFS, grows the block tables of the
decoding lanes (preempting the youngest request when the pool runs dry),
then advances every decoding lane with ONE batched decode step and samples
a token per lane. The route is the ``ServeConfig``'s, as in the reference:

* prefill: ``batched_prefill=True`` runs the whole prompt in one pass
  (``prefill_impl="ss_fused"``: kernels K1/K2; ``"replay"``: every
  position's decode attention at once); ``batched_prefill=False`` feeds
  the prompt one token per tick through the decode step (token replay);
* decode: ``decode_impl="paged"`` reads the pools through kernel K5
  (gather-free); ``"gather"`` gathers dense lane views first. The gather
  route also serves ``decode_streaming="recompute"``, which a paged
  request falls back to (``stats()["decode_impl"]`` says so);
* storage: ``paged=False`` keeps every lane's K/V dense (the reference's
  seed engine), with no allocator.

``ServeConfig()``'s defaults (replay prefill, gather decode) run no kernel,
in the reference as here.

``ServeConfig(chunked_prefill=True)`` (or ``prefix_cache=True``) switches to
the continuous-batching tick (``_tick_chunked``, ``engine.py:1201``):
decode dispatch first, then admissions (a parked request resumes at its
chunk boundary, a prefix-cache hit attaches), then prompt chunks in
admission order up to ``prefill_token_budget`` (``chunk_prefill``: K1 in
the stats handoff under ``prefill_impl="ss_fused"`` when a chunk is longer
than c), then the all-prefill deadlock breaker, then the host sync at the
sample boundary. ``prefix_cache=True`` (paged storage only; with
``paged=False`` the flag is inert, as in the reference) maps cached
blocks into a request's table: a full hit emits its first token from the
cached logits, a partial hit resumes chunked prefill at a cached
block-aligned boundary, and a shared partial block is copied before the
first divergent write.

``decode_streaming="frozen"`` ticks stream every landmark row (no K5, no
horizon read); after the emit, each lane whose just-written position
starts a new landmark segment is rebased (``decode_state.rebase_layer``
over a gathered view: plain torch, no kernel), in both ticks.

The request lifecycle and recovery ladder (``engine.py:195-231``,
``:495-558``, ``:823-1087``): ``submit`` returns False when ``max_queue``
rejects; ``cancel`` and ``Request.deadline_ticks`` end a request wherever
it is, releasing every block, pin and snapshot it holds; ``outcomes``
records each uid's one terminal state (finished / cancelled / rejected /
deadline_expired). A ``FaultPlan`` (``serve/chaos.py``) injects faults at
the reference's sites in the reference's order, so a plan fires on the
same opportunities in both engines. ``numerics_guard`` scans each
decoded lane: NaN streaming stats quarantine it (every stats row
reseeded exactly from its K/V), non-finite logits replay-preempt it, and
after ``numerics_demote_after`` trips a frozen lane is demoted to the
exact program (on the paged route K5 runs for it). ``watchdog_ticks``
arms the no-progress watchdog: reclaim parked blocks, then preempt the
youngest lane, then raise ``EngineStalled``. The scheduler's always-real
registry counts the ladder (``numerics_quarantines_total``,
``numerics_demotions_total``, ``serve_watchdog_fires_total``,
``serve_recovery_ticks``).

``ServeConfig(telemetry=True)`` (or a caller's ``Telemetry``) turns on the
reference's instrumentation at its call points (``engine.py:163-492``,
``:1082-1507``): one registry shared by the scheduler, the prefix cache
and the chaos injector; the tick spans ``serve_tick``, ``admit``,
``prefill``, ``prefill_chunk``, ``decode_dispatch``, ``device_sync``,
``sample_emit`` and ``rebase``; the flight lifelines; the pool fn-gauges
and per-tick counter samples; ``SpectrumMonitor`` at retirement and at
each rebase, ``DriftMonitor`` at each frozen rebase; the numerics probe
every ``numerics_probe_every`` ticks; and program accounting over
``prefill``, ``prefill_chunk``, ``decode_tick``, ``rebase``,
``prefix_attach`` and ``decode_exact`` (``stats()["program_shapes"]``:
argument signatures, the counterpart of the reference's XLA compiles).
With telemetry off every site calls the shared no-op objects: no device
sync, no allocation, no ``stats()`` key. Nothing on the telemetry path
touches the generator, the storage or the logits, so greedy tokens do
not move. On CUDA the spans are host time: ``decode_dispatch`` holds the
eager launches of the step and the syncs hidden in them (the commit's
``torch.nonzero``, the pageable uploads of tables and tokens), and
``device_sync`` the wait for the logits' copy to the host.

Host syncs of the chunked tick on CUDA, besides the one at the sample
boundary: the decode step's commit (``PagedKVCache._commit``,
``torch.nonzero``), every upload of a host array (tables, tokens,
positions: pageable copies), and the stat-point snapshots taken while a
prefill runs with the prefix cache on. The first means chunk dispatch
does not overlap the decode step. A frozen rebase ends in a sync (its
time is ``stats()["rebase_s"]``), and the numerics guard syncs once per
tick for its scan of the streaming stats.

Runs on CUDA unless the caller passes ``device="cpu"`` (the kernels' plain
versions then run instead); asking for CUDA without a GPU raises.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.kernels import HEAD_DIM_LIMITS, SERVE_KERNELS, dispatch, kernels_past
from repro_torch.models.model import working_params
from repro_torch.serve.chaos import ChaosInjector, EngineStalled, FaultPlan
from repro_torch.serve.decode import decode_step
from repro_torch.serve.decode_state import (STREAM_LEAVES, make_rebase_fn,
                                            make_reseed_fn, segment_len)
from repro_torch.serve.paged import (BlockAllocator, PagedKVCache, PrefixCache,
                                     bucket_view_slots)
from repro_torch.serve.prefill import (batched_prefill, make_chunk_prefill_fn,
                                      prefill_supported)
from repro_torch.serve.scheduler import Scheduler
from repro_torch.telemetry import (DriftMonitor, NullNumericsProbe, NumericsProbe,
                                   ProgramAccounting, SpectrumMonitor, Telemetry,
                                   bv_row_residual)
from repro_torch.telemetry import accounting
from repro_torch.telemetry.metrics import TICK_BUCKETS

# the programs of program accounting, in the reference's stats() order
PROGRAMS = ("prefill", "prefill_chunk", "decode_tick", "rebase", "prefix_attach",
            "decode_exact")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 => greedy
    # streamed-token callback: on_token(uid, token) fires as each token is
    # sampled, inside the tick
    on_token: Optional[object] = None
    # tick budget from submission: past it the request ends with outcome
    # "deadline_expired" wherever it is and releases all it holds. 0: none
    deadline_ticks: int = 0


@dataclasses.dataclass
class _Lane:
    req: Optional[Request] = None
    prompt_left: deque = dataclasses.field(default_factory=deque)  # token replay
    generated: list[int] = dataclasses.field(default_factory=list)
    next_token: int = 0
    pos: int = 0              # cache position the next decode step writes to
    prefilled_tick: int = -1  # tick of the prefill (no decode that tick)
    # chunked prefill: mid-prefill lanes are not decode candidates
    prefilling: bool = False
    prefill_pos: int = 0      # prompt tokens committed so far
    chunk_idx: int = 0        # next chunk ordinal (flight lifeline labels)
    # prefix cache: dense snapshots at block-aligned chunk boundaries
    # (token count -> dense_snapshot), given to the cache entry at the end
    stat_points: dict = dataclasses.field(default_factory=dict)

    @property
    def free(self) -> bool:
        return self.req is None


def resolve_device(device) -> torch.device:
    """The engine's device; CUDA without a GPU raises instead of quietly
    running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no GPU is available; "
                           "pass device='cpu' to run the plain versions")
    return device


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def kernel_head_dims(cfg: ModelConfig) -> tuple[int, int]:
    """The (d, dv) the serving kernels see: absorbed MLA's keys of kv_lora +
    rope columns and its kv_lora-wide latent values, else the head dim."""
    if cfg.mla:
        return cfg.kv_lora_rank + cfg.rope_head_dim, cfg.kv_lora_rank
    return cfg.resolved_head_dim, cfg.resolved_head_dim


# every family of the reference's engine
FAMILIES = ("dense", "moe", "hybrid", "vlm", "ssm", "audio")


def _check_supported(cfg: ModelConfig, serve: ServeConfig, device: torch.device) -> None:
    d, dv = kernel_head_dims(cfg)
    past = [f"{name} ({HEAD_DIM_LIMITS[name][0]}, {HEAD_DIM_LIMITS[name][1]})"
            for name in kernels_past(d, dv, SERVE_KERNELS)]
    unsupported = {
        # MLA / MoE layers are served as family "moe" (its cache layout);
        # the other families with those flags set are refused
        f"family {cfg.family!r}": (
            cfg.family not in FAMILIES
            or (cfg.family != "moe" and (cfg.mla or cfg.moe))),
        # each serving kernel takes head dims up to its own limit: refused
        # here, not on the first tick
        f"head dims (d={d}, dv={dv}) past {', '.join(past)} on CUDA":
            device.type == "cuda" and bool(past),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *,
                 serve: Optional[ServeConfig] = None, device="cuda",
                 chaos: Optional[FaultPlan] = None, telemetry: Optional[Telemetry] = None):
        serve = serve or ServeConfig()
        self.device = resolve_device(device)
        _check_supported(cfg, serve, self.device)
        self.cfg, self.serve = cfg, serve
        # one registry, tracer and flight recorder behind ServeConfig.telemetry
        # (or a caller's Telemetry); disabled: the shared no-op objects. The
        # scheduler keeps a real registry either way (its percentiles are
        # part of stats()) and shares this one when telemetry is on.
        self.telemetry = telemetry if telemetry is not None else Telemetry(
            enabled=serve.telemetry)
        self.telemetry.stamp_provenance(cfg, serve, device=self.device)
        tel_reg = self.telemetry.metrics if self.telemetry.enabled else None
        # Program accounting over the hot programs (``engine.py:461``): a
        # steady-state engine shows program_shapes_total flat.
        self._acct = None
        if tel_reg is not None:
            accounting.set_metrics(tel_reg)  # the kernel-build hook counts too
            self._acct = ProgramAccounting(tel_reg)
        # working copy cast once (the reference casts inside each program)
        self.params = working_params(tree_to(params, self.device), cfg)
        self.max_lanes, self.max_seq = serve.max_lanes, serve.max_seq
        self.eos_id = serve.eos_id
        self.lanes = [_Lane() for _ in range(self.max_lanes)]
        self.finished: dict[int, list[int]] = {}
        self._gen = torch.Generator().manual_seed(serve.seed)  # temperature > 0
        self._tick = 0
        # wall seconds in whole-prompt prefills and in decode ticks (each
        # ends in a host sync on its logits, so these are device-inclusive);
        # the chunked tick's wall, apart for ticks that ran chunks
        self.prefill_s = self.decode_s = 0.0
        # parks: victims parked mid-prefill; parked_resumes: of those, the
        # ones re-admitted onto their kept blocks (not reclaimed first)
        self.decode_ticks = self.chunks = self.parks = self.parked_resumes = 0
        self.chunk_ticks = self.plain_ticks = 0
        self.chunk_tick_s = self.plain_tick_s = 0.0

        self.kv = PagedKVCache(cfg, serve, self.device)
        alloc = (BlockAllocator(serve.resolved_num_blocks, serve.block_size)
                 if self.kv.paged else None)
        # The prefix cache rides the chunked tick and needs paged storage
        # and a family with batched prefill; the chunked tick needs batched
        # prefill too (silently off otherwise, ``engine.py:180-197``).
        self._prefix_enabled = (serve.prefix_cache and self.kv.paged
                                and prefill_supported(cfg))
        self._chunked = ((serve.chunked_prefill or self._prefix_enabled)
                         and prefill_supported(cfg))
        # chunk rounded up to a block multiple: chunk starts stay aligned
        bs = serve.block_size
        self._chunk = min(-(-serve.prefill_chunk_tokens // bs) * bs, self.max_seq)
        self.sched = Scheduler(alloc, self.max_lanes, serve.blocks_per_lane,
                               registry=tel_reg,
                               flight=self.telemetry.flight if self.telemetry.enabled else None,
                               chunk_tokens=self._chunk if self._chunked else 0,
                               max_queue=serve.max_queue)
        self.sched.requeue_cb = self._on_preempt
        if self._chunked:
            self.sched.park_cb = self._park_lane
            self.sched.park_drop_cb = self._drop_parked
        self._parked: dict[int, dict] = {}  # uid -> snapshot + progress
        self.prefix = None
        if self._prefix_enabled:
            self.prefix = PrefixCache(alloc, max_blocks=serve.prefix_cache_blocks,
                                      registry=tel_reg)
            self.sched.prefix_probe = self._prefix_probe
            self.sched.cow_cb = self.kv.copy_block
            self._probe_pins: dict[int, object] = {}  # uid -> soft-pinned entry

        # Terminal outcomes: every submitted uid ends in exactly one of
        # finished / cancelled / rejected / deadline_expired. Guard and
        # watchdog state beside them (``engine.py:195``).
        self.outcomes: dict[int, str] = {}
        self._deadlines: dict[int, int] = {}     # uid -> expiry tick
        self._guard_trips: dict[int, int] = {}   # uid -> guard hits
        self._demoted: set[int] = set()          # uids pinned to exact mode
        self._exact_step = None                  # built at the first demotion
        self._progress = True
        self._stall_ticks = self._wd_interventions = 0
        self._wd_fired_tick: Optional[int] = None
        reg = self.sched.registry
        self._quarantines = reg.counter(
            "numerics_quarantines_total",
            help="lanes quarantined by the numerics guard (streaming stats "
                 "rebuilt in place from cached K/V)")
        self._demotions = reg.counter(
            "numerics_demotions_total",
            help="frozen-mode lanes demoted to the exact decode program after "
                 "repeated numerics-guard trips")
        self._wd_fires = reg.counter("serve_watchdog_fires_total",
                                     help="no-progress watchdog escalations")
        self._recovery_h = reg.histogram(
            "serve_recovery_ticks",
            help="ticks from the first watchdog intervention to restored progress",
            buckets=TICK_BUCKETS)
        # one injector for every site, so the per-tick ordinals (and with
        # them the whole schedule) replay from (plan.seed, tick)
        self.chaos = None
        if chaos is not None:
            self.chaos = ChaosInjector(chaos, flight=self.sched.flight,
                                       registry=self.sched.registry)
            self.sched.chaos = self.chaos
            if alloc is not None:
                alloc.chaos = self.chaos
            if self.prefix is not None:
                self.prefix.chaos = self.chaos
        if self.telemetry.enabled:
            reg = self.telemetry.metrics
            self._ticks_total = reg.counter("serve_ticks_total", help="engine ticks executed")
            if alloc is not None:
                # fn-gauges: evaluated only when the registry is read
                reg.gauge("pool_blocks_used", fn=lambda: float(alloc.num_used),
                          help="allocated KV blocks")
                reg.gauge("pool_blocks_free", fn=lambda: float(alloc.num_free),
                          help="free KV blocks")
                reg.gauge("pool_utilization",
                          fn=lambda: alloc.num_used / max(alloc.num_blocks - 1, 1),
                          help="allocated fraction of the usable pool")
                reg.gauge("pool_fragmentation", fn=alloc.fragmentation,
                          help="1 - longest contiguous free run / free blocks")

        # Decode route (``engine.py:296-328``): recompute-mode spectral shift
        # rebuilds the dense B matrix, so only the gather route serves it.
        paged_ok = self.kv.paged and not (
            cfg.decode_attention_impl == "spectral_shift"
            and cfg.decode_streaming == "recompute")
        self.decode_impl = ("paged" if serve.decode_impl == "paged" and paged_ok
                            else "gather")
        self.batched = serve.batched_prefill and prefill_supported(cfg)
        self._warm_plans(cfg, serve)
        self._step = self._make_step(cfg, "decode_tick")
        self._prefill = self._account(
            lambda tokens, n: batched_prefill(self.params, cfg, tokens, n,
                                              seq_max=self.max_seq,
                                              prefill_impl=serve.prefill_impl),
            "prefill")
        if self._chunked:
            self._chunk_step = self._account(self.kv.make_chunk_step(
                make_chunk_prefill_fn(self.params, cfg, seq_max=self.max_seq,
                                      stats_impl=serve.prefill_impl), self._chunk),
                "prefill_chunk")
        # the streaming stats exist (exact / frozen spectral shift): they
        # can be reseeded from K/V and the guard scans them
        self._streams = (cfg.decode_attention_impl == "spectral_shift"
                         and cfg.decode_streaming in ("exact", "frozen"))
        # frozen: the boundary rebase after the emit (``engine.py:330``)
        self._seg = segment_len(self.max_seq, cfg.num_landmarks)
        self.rebases = 0
        self.rebase_s = 0.0
        self._frozen_rebase = self._streams and cfg.decode_streaming == "frozen"
        if self._frozen_rebase:
            self._rebase_step = self._account(
                self.kv.make_rebase_step(make_rebase_fn(cfg, self.max_seq)), "rebase",
                static=(3,))
        # "recompute" attach: every stats row re-derived from the shared K/V
        self._reseed_step = None
        if self._prefix_enabled and serve.prefix_attach == "recompute" and self._streams:
            self._ensure_reseed_step()
        # bucket rounded up to a block multiple so prefill writes whole blocks
        self._bucket = -(-serve.prefill_bucket // bs) * bs

        # Online monitors (telemetry only): the landmark-mass spectrum at
        # retirements and rebases, the drift residual at frozen rebases.
        self._drift_mon = self._spectrum_mon = None
        if self.telemetry.enabled and self._streams:
            self._spectrum_mon = SpectrumMonitor(self.telemetry.metrics)
            if self._frozen_rebase:
                self._drift_mon = DriftMonitor(self.telemetry.metrics)
        # the numerics probe forces a sync: ServeConfig.numerics_probe_every
        # sets its cadence
        self._numerics = (NumericsProbe(tel_reg)
                          if tel_reg is not None and serve.numerics_probe_every > 0
                          else NullNumericsProbe())

    def _warm_plans(self, cfg: ModelConfig, serve: ServeConfig) -> None:
        """Warm the dispatch registry for the serving shapes
        (``engine.py:399-441``): the decode key (one step against the
        max_seq horizon; with ``autotune=True`` an unseen key runs the
        measured sweep here, once, at this deployment's block size, lanes
        and heads: K5's tilings, and on the CPU the gather route too) and,
        for ss_fused prefill, the full-sequence key whose plan tiles K1 /
        K2. Resolution loads the disk cache, ``autotune_cache`` moving it.
        The decode plan's ``block_table`` is the paged tick's view quantum;
        its ``block_n`` (K5's chunk, a paged plan's only) and the prefill
        plan's ``block_n`` (K1 / K2's) reach every launch of a tick through
        ``dispatch.use_tiling`` (0 = the kernels' own plans, what the
        heuristic gives)."""
        if self.telemetry.enabled:
            dispatch.set_metrics(self.telemetry.metrics)
        if cfg.autotune_cache:
            dispatch.set_cache_path(cfg.autotune_cache)
            dispatch.load_cache()
        d = cfg.resolved_head_dim
        hkv = 1 if cfg.mla else cfg.num_kv_heads

        def tune_decode(key):
            return dispatch.autotune_decode(
                key.n, key.c, key.d, dtype=key.dtype, backend=key.backend,
                block_size=serve.block_size, lanes=self.max_lanes, hkv=hkv,
                rows=cfg.num_heads // hkv)

        dev = self.device.type
        self.decode_plan = dispatch.get_plan(dispatch.make_key(
            self.max_seq, cfg.num_landmarks, d, cfg.compute_dtype, True, backend=dev,
            family="decode"), autotune_enabled=cfg.autotune, tune_fn=tune_decode)
        paged = self.decode_impl == "paged"
        self._view_quantum = self.decode_plan.block_table if paged else 0
        self._chunk_slots = (self.decode_plan.block_n
                             if paged and self.decode_plan.impl == "paged" else 0)
        self._prefill_block = 0
        self.prefill_plan = None
        if self.batched and serve.prefill_impl == "ss_fused":
            self.prefill_plan = dispatch.get_plan(dispatch.make_key(
                self.max_seq, cfg.num_landmarks, d, cfg.compute_dtype, False,
                backend=dev))
            self._prefill_block = self.prefill_plan.block_n

    def _account(self, fn, program: str, static=()):
        """``fn`` under program accounting when telemetry is on. ``static``:
        the arguments whose value enters the signature, the gather route's
        view length (argument 4 of a decode tick, 3 of a rebase or reseed),
        a shape in the reference."""
        return fn if self._acct is None else self._acct.wrap(fn, program, static)

    def _make_step(self, cfg: ModelConfig, program: str):
        """The decode tick of ``cfg`` on the engine's route, accounted as
        ``program``."""
        if self.decode_impl == "paged":
            return self._account(self.kv.make_paged_step(
                lambda cache, tokens, table: decode_step(
                    self.params, cfg, cache, tokens, seq_max=self.max_seq,
                    paged_table=table, block_size=self.serve.block_size)), program)
        return self._account(self.kv.make_fused_step(
            lambda cache, tokens: decode_step(self.params, cfg, cache, tokens,
                                              seq_max=self.max_seq)), program, static=(4,))

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request. False when the ``max_queue`` bound rejects it
        (outcome "rejected"); ``max_queue=0`` never rejects."""
        if len(req.prompt) >= self.max_seq:
            raise ValueError(
                f"prompt len {len(req.prompt)} >= max_seq {self.max_seq}")
        if not self.sched.submit(req):
            self.outcomes[req.uid] = "rejected"
            return False
        self.outcomes.pop(req.uid, None)  # a resubmit sheds a stale outcome
        if req.deadline_ticks > 0:
            self._deadlines[req.uid] = self._tick + req.deadline_ticks
        return True

    def cancel(self, uid: int) -> bool:
        """End ``uid`` wherever it is (queued, parked, decoding) and release
        all it holds. False for an unknown or already-ended uid."""
        return self._terminalize(uid, "cancelled")

    def run(self, max_ticks: int = 10_000) -> dict[int, list[int]]:
        """Drive until queue and lanes drain (or the tick budget)."""
        for _ in range(max_ticks):
            if self.sched.idle:
                break
            self.tick()
        return self.finished

    def defragment(self) -> int:
        """Compact the live blocks onto the lowest pool ids and move the
        pools to match (``engine.py:1463``); safe between ticks. Returns
        the number of blocks moved."""
        if self.sched.allocator is None:
            return 0
        mapping = self.sched.allocator.defragment()
        self.kv.apply_mapping(mapping)
        return len(mapping)

    def stats(self) -> dict:
        st = self.sched.stats()
        prefill = ("chunked" if self._chunked
                   else "batched" if self.batched else "replay")
        st.update(
            ttft_s=[t.ttft_s for t in self.sched.timing.values()
                    if t.ttft_s is not None],
            ticks=self._tick, prefill_s=self.prefill_s, decode_s=self.decode_s,
            decode_ticks=self.decode_ticks, chunks=self.chunks,
            parks=self.parks, parked_resumes=self.parked_resumes,
            chunk_ticks=self.chunk_ticks, chunk_tick_s=self.chunk_tick_s,
            plain_ticks=self.plain_ticks, plain_tick_s=self.plain_tick_s,
            mode=f"{'paged' if self.kv.paged else 'dense'}+{prefill}-prefill",
            decode_plan=(f"{self.decode_plan.impl}/b{self.decode_plan.block_n}"
                         + (f"/t{self.decode_plan.block_table}"
                            if self.decode_plan.block_table else "")
                         + f"/{self.decode_plan.source}"),
            decode_impl=self.decode_impl,
            decode_streaming=self.cfg.decode_streaming,
            quarantines=int(self._quarantines.value), demotions=int(self._demotions.value),
            watchdog_fires=int(self._wd_fires.value))
        if self._frozen_rebase:
            st.update(rebases=self.rebases, rebase_s=self.rebase_s)
        if self.chaos is not None:
            st["chaos_injections"] = self.chaos.injections
        if self.prefix is not None:
            st["prefix"] = self.prefix.stats()
        if self.telemetry.enabled:
            st["telemetry"] = self.telemetry.tracer.summary()
            st["flight"] = self.telemetry.flight.summary()
            st["program_shapes"] = {p: self._acct.shapes(p) for p in PROGRAMS}
        return st

    # -- request lifecycle -----------------------------------------------------
    def _expire_deadlines(self) -> None:
        expired = [u for u, d in self._deadlines.items() if self._tick > d]
        for uid in expired:
            self._terminalize(uid, "deadline_expired")

    def _terminalize(self, uid: int, outcome: str) -> bool:
        """The cancel / deadline exit (``engine.py:527``): releases the
        queue slot, the scheduler's parked entry and its blocks, the parked
        snapshot, the prefix probe pin, the guard state and the lane."""
        self._deadlines.pop(uid, None)
        if uid in self.outcomes or uid in self.finished:
            return False
        req = self.sched.remove_waiting(uid)
        if req is not None:
            self.sched.parked.pop(uid, None)
            self._parked.pop(uid, None)
            if self.sched.allocator is not None:
                self.sched.allocator.free(uid)
            if self.prefix is not None:
                pinned = self._probe_pins.pop(uid, None)
                if pinned is not None:
                    self.prefix.unpin(pinned)
            self.sched.mark_terminal(uid, outcome)
        else:
            seat = next((i for i, l in enumerate(self.lanes)
                         if l.req is not None and l.req.uid == uid), None)
            if seat is None:
                return False
            self.sched.discard(seat, outcome)
            self.lanes[seat] = _Lane()
        self.outcomes[uid] = outcome
        self._guard_trips.pop(uid, None)
        self._demoted.discard(uid)
        return True

    # -- scheduling hooks ------------------------------------------------------
    def _on_preempt(self, lane_idx: int) -> Optional[Request]:
        req = self.lanes[lane_idx].req
        self.lanes[lane_idx] = _Lane()
        return req

    def _park_lane(self, lane_idx: int) -> bool:
        """Scheduler park hook (``engine.py:576``): a victim caught
        mid-chunked-prefill with committed chunks keeps its blocks; its
        carried dense state is saved as host copies. Lane-dense storage
        cannot park (the lane's rows are reused)."""
        lane = self.lanes[lane_idx]
        if (lane.req is None or not lane.prefilling or lane.prefill_pos <= 0
                or not self.kv.paged):
            return False
        self._parked[lane.req.uid] = {"snap": self.kv.dense_snapshot(lane_idx),
                                      "prefill_pos": lane.prefill_pos,
                                      "chunk_idx": lane.chunk_idx}
        self.parks += 1
        return True

    def _drop_parked(self, uid: int) -> None:
        """A parked request's blocks were reclaimed: it recomputes."""
        self._parked.pop(uid, None)

    def _retire(self, i: int) -> None:
        lane = self.lanes[i]
        if self._spectrum_mon is not None and lane.pos > 0:
            # the finished request's landmark-mass concentration
            m, l = self._lane_m_l(i)
            self._spectrum_mon.observe(
                m, l, min((lane.pos - 1) // self._seg + 1, self.cfg.num_landmarks))
        uid = lane.req.uid
        self.finished[uid] = list(lane.generated)
        self.outcomes[uid] = "finished"
        self._deadlines.pop(uid, None)
        self._guard_trips.pop(uid, None)
        self._demoted.discard(uid)
        self.sched.release(i)
        self.lanes[i] = _Lane()

    # -- prefix cache ----------------------------------------------------------
    def _plan_attach(self, req: Request):
        """``(entry, n_tokens, full)``: share the blocks of the first
        ``n_tokens`` prompt tokens; ``full`` means the whole prompt (the
        cached logits emit the first token), else chunked prefill resumes
        at the block-aligned stat point ``n_tokens``. None: nothing usable
        (``engine.py:600``). Parked requests resume their own blocks."""
        if (self.prefix is None or req.uid in self.sched.parked
                or req.uid in self._parked):
            return None
        m = self.prefix.match(req.prompt)
        if m is None:
            return None
        entry, k = m
        bs, n = self.serve.block_size, len(req.prompt)
        if self.prefix.is_full_hit(entry, req.prompt, k) and n in entry.stat_points:
            return entry, n, True
        # partial: the deepest block-aligned stat point inside the match,
        # leaving at least one token to prefill
        cap = min(k * bs, n - 1)
        best = max((p for p in entry.stat_points if 0 < p <= cap and p % bs == 0),
                   default=0)
        return (entry, best, False) if best else None

    def _prefix_probe(self, req: Request) -> int:
        """Scheduler hook: prompt tokens a cached prefix will cover at
        admission (0: cold); the matched entry stays soft-pinned until the
        attach (``engine.py:638``)."""
        plan = self._plan_attach(req)
        entry = plan[0] if plan is not None else None
        prev = self._probe_pins.pop(req.uid, None)
        if prev is not None and prev is not entry:
            self.prefix.unpin(prev)
        if entry is not None:
            if prev is entry:
                self.prefix.touch(entry)
            else:
                self.prefix.pin(entry)
            self._probe_pins[req.uid] = entry
        return plan[1] if plan is not None else 0

    def _try_attach_prefix(self, i: int, req: Request) -> bool:
        """Admission-time attach (``engine.py:663``): map the shared blocks
        in front of the tail the scheduler allocated, restore the cached
        dense snapshot, then emit the first token from the cached logits
        (full hit) or resume chunked prefill at the boundary (partial)."""
        pinned = self._probe_pins.pop(req.uid, None)
        if pinned is not None:
            self.prefix.unpin(pinned)
        plan = self._plan_attach(req)
        if plan is None:
            self.prefix.note_miss()
            return False
        entry, n_attach, full = plan
        bs = self.serve.block_size
        blocks = entry.blocks[:-(-n_attach // bs) if full else n_attach // bs]
        self.sched.allocator.attach_shared(req.uid, blocks)
        self.kv.dense_restore(i, entry.stat_points[n_attach])
        lane = self.lanes[i]
        # the stat points up to the attach hold for this prompt too
        lane.stat_points = {p: s for p, s in entry.stat_points.items() if p <= n_attach}
        if full:
            lane.pos = n_attach
            lane.prefilled_tick = self._tick
        else:
            lane.prefill_pos = n_attach
            lane.prefilling = True
        self.prefix.note_hit(entry, len(blocks))
        self.sched.mark_prefix_hit(req.uid)
        self.telemetry.flight.record(req.uid, "prefix_attach", tick=self._tick, lane=i,
                                     blocks=len(blocks), tokens=n_attach,
                                     mode="full" if full else "partial")
        if self._reseed_step is not None:
            self._run_reseed(i, n_attach - 1)
        if full:
            self._emit_token(i, np.asarray(entry.logits, np.float32))
        return True

    def _run_reseed(self, i: int, last_pos: int) -> None:
        """The stats reseed of one lane (``engine.py:721``): every reached
        row recomputed over the lane's K/V, keys 0..last_pos."""
        positions = np.zeros(self.max_lanes, np.int32)
        positions[i] = last_pos
        self._reseed_step(self.sched.tables(), positions, [i],
                          self.kv.view_blocks_needed(positions, [i]))

    def _maybe_cache_prefix(self, i: int, logits: np.ndarray) -> None:
        """Completed prefill (``engine.py:736``): the final stat point (the
        dense state after the whole prompt) and the prompt go into the
        index; the entry takes its own block references."""
        lane = self.lanes[i]
        req = lane.req
        if self.prefix is None or len(req.prompt) < self.serve.block_size:
            return
        lane.stat_points[len(req.prompt)] = self.kv.dense_snapshot(i)
        self.prefix.insert(req.prompt, self.sched.allocator.tables.get(req.uid, []),
                           stat_points=lane.stat_points, logits=logits)

    # -- prefill phase ---------------------------------------------------------
    def _run_prefill(self, i: int, req: Request) -> None:
        t0 = time.perf_counter()
        lane = self.lanes[i]
        n = len(req.prompt)
        if self.serve.prefill_impl == "ss_fused" and n <= self.cfg.num_landmarks:
            # Degenerate tiny prompt: the exact-attention window has no
            # use for padding, so run unpadded.
            n_pad = n
        else:
            # Bucketed padding; kv_valid masks the pad out of the kernels.
            n_pad = min(-(-n // self._bucket) * self._bucket, self.max_seq)
        tokens = torch.zeros((1, n_pad), dtype=torch.long)
        tokens[0, :n] = torch.as_tensor(req.prompt)
        self.telemetry.flight.record(req.uid, "prefill_start", bucket=n_pad, lane=i,
                                     tick=self._tick)
        logits, pcache = self._prefill(tokens.to(self.device), n)
        self.kv.write_prefill(i, pcache, self.sched.table_row(i), n_tokens=n)
        lane.pos = n
        lane.prefilled_tick = self._tick
        lg = logits[0, n - 1, : self.cfg.vocab_size].float().cpu().numpy()
        self.telemetry.flight.record(req.uid, "prefill_end", bucket=n_pad)
        self.prefill_s += time.perf_counter() - t0
        self._emit_token(i, lg)

    # -- sampling / retirement -------------------------------------------------
    def _sample(self, lane: _Lane, lg: np.ndarray) -> int:
        if lane.req.temperature > 0:
            u = torch.rand(lg.shape, generator=self._gen, dtype=torch.float64)
            gumbel = (-torch.log(-torch.log(u.clamp_min(1e-20)))).numpy()
            return int(np.argmax(lg / lane.req.temperature + gumbel))
        return int(np.argmax(lg))

    def _emit_token(self, i: int, lg: np.ndarray) -> None:
        lane = self.lanes[i]
        tok = self._sample(lane, lg)
        lane.generated.append(tok)
        self._progress = True
        self.sched.note_token(lane.req.uid)
        if lane.req.on_token is not None:
            lane.req.on_token(lane.req.uid, tok)
            if self.lanes[i] is not lane:
                return  # the callback cancelled this very request
        if (tok == self.eos_id or len(lane.generated) >= lane.req.max_new_tokens
                or lane.pos + 1 >= self.max_seq):
            self._retire(i)
        else:
            lane.next_token = tok

    # -- decode dispatch (normal + demoted lanes) ------------------------------
    def _dispatch_decode(self, active: list[int]) -> list[tuple]:
        """One batched decode step for the active lanes (inactive lanes run
        masked and commit nothing), without syncing on the logits. Lanes
        the guard demoted run the exact program as a second step over the
        same storage (``engine.py:823``). Returns ``[(device logits
        (max_lanes, 1, V), lanes)]`` for ``_merge_logits``."""
        if self._demoted:
            normal = [i for i in active if self.lanes[i].req.uid not in self._demoted]
            demoted = [i for i in active if self.lanes[i].req.uid in self._demoted]
        else:
            normal, demoted = active, []
        groups = [(self._step, normal)]
        if demoted:
            self._ensure_exact_step()
            groups.append((self._exact_step, demoted))
        dev = self.device
        tables = torch.as_tensor(self.sched.tables(), device=dev)
        parts = []
        for step_fn, group in groups:
            if not group:
                continue
            tokens = np.zeros((self.max_lanes, 1), np.int64)
            positions = np.zeros(self.max_lanes, np.int32)
            mask = np.zeros(self.max_lanes, bool)
            for i in group:
                tokens[i, 0] = self.lanes[i].next_token
                positions[i] = self.lanes[i].pos
                mask[i] = True
            table = tables
            if self.decode_impl == "paged" and self._view_quantum:
                # a measured view quantum: the table cut to a multiple of it
                table = tables[:, :self.kv.view_blocks_needed(
                    positions, group, self._view_quantum)].contiguous()
            args = [table, torch.as_tensor(tokens, device=dev),
                    torch.as_tensor(positions, device=dev),
                    torch.as_tensor(mask, device=dev)]
            if self.decode_impl == "gather":
                args.append(self.kv.view_blocks_needed(positions, group))
            parts.append((step_fn(*args), group))
        return parts

    @staticmethod
    def _merge_logits(parts: list[tuple]) -> Optional[np.ndarray]:
        """Sync the dispatched parts to one (max_lanes, V) host array
        (``engine.py:863``); None when nothing decoded."""
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0][0][:, 0].float().cpu().numpy()
        out = None
        for dev_logits, group in parts:
            host = dev_logits[:, 0].float().cpu().numpy()
            if out is None:
                out = np.zeros_like(host)
            out[group] = host[group]
        return out

    def _ensure_exact_step(self) -> None:
        """The exact decode program for demoted lanes (``engine.py:879``):
        exact and frozen share the storage layout, so demoted lanes ride
        the same pools (on the paged route, through K5)."""
        if self._exact_step is None:
            self._exact_step = self._make_step(
                dataclasses.replace(self.cfg, decode_streaming="exact"), "decode_exact")

    def _ensure_reseed_step(self) -> bool:
        """The stats-reseed program (``engine.py:906``), shared by the
        recompute attach and the guard's quarantine; False when the decode
        state does not stream."""
        if self._reseed_step is None and self._streams:
            self._reseed_step = self._account(self.kv.make_rebase_step(
                make_reseed_fn(self.cfg, self.max_seq)), "prefix_attach", static=(3,))
        return self._reseed_step is not None

    def _grow_decoders(self, candidates: list[int]) -> list[int]:
        """Grow the candidates' block tables (may preempt, youngest first);
        a lane whose own request was preempted, or cannot grow, drops out
        of this tick's step."""
        active = []
        for i in candidates:
            if self.lanes[i].free:  # preempted as a victim earlier this loop
                continue
            if self.sched.ensure_block(i, self.lanes[i].pos):
                active.append(i)
        return [i for i in active if not self.lanes[i].free]

    # -- chaos sites and the numerics guard ------------------------------------
    def _apply_tick_chaos(self) -> None:
        """Tick-scoped sites, once per tick at the top (``engine.py:925``)."""
        ch = self.chaos
        rule = ch.fire("tick_delay")
        if rule is not None:
            time.sleep(rule.param or 1e-3)
        rule = ch.fire("fragment")
        if rule is not None and self.sched.allocator is not None:
            self.sched.allocator.scramble_free(ch.plan.seed + self._tick)
        rule = ch.fire("evict_storm")
        if rule is not None and self.prefix is not None:
            for _ in range(int(rule.param) or 4):
                if not self.prefix.evict_one():
                    break

    def _apply_decode_chaos(self, active: list[int], logits: np.ndarray) -> None:
        """Post-step corruption (``engine.py:940``): a lane's streaming
        stats (every layer) on the device, its logits row on the host;
        before the guard's scan, so the same tick detects it."""
        ch = self.chaos
        for i in active:
            if self.lanes[i].free:
                continue
            if self._streams and ch.fire("nan_stats", lane=i) is not None:
                for name in STREAM_LEAVES:
                    self.kv.storage[name][:, i] = float("nan")
            if ch.fire("nan_logits", lane=i) is not None:
                logits[i, : self.cfg.vocab_size] = np.nan

    def _post_decode_checks(self, active: list[int], logits: Optional[np.ndarray]):
        """Post-sync, pre-emit (``engine.py:959``): the numerics probe at its
        cadence (the host logits, each active lane's ``m`` and ``l`` where
        they lie), chaos corruption, then the guard's scan."""
        probe_every = self.serve.numerics_probe_every
        if probe_every > 0 and self._tick % probe_every == 0 and self.telemetry.enabled:
            if logits is not None:
                self._numerics.check("decode_logits", logits)
            if self._streams:
                m_all, l_all = self.kv.storage["bv_m"], self.kv.storage["bv_l"]
                for i in active:
                    self._numerics.check("landmark_m", m_all[:, i])
                    self._numerics.check("landmark_l", l_all[:, i])
        if logits is None:
            return None
        if self.chaos is not None:
            if not logits.flags.writeable:
                logits = logits.copy()
            self._apply_decode_chaos(active, logits)
        if self.serve.numerics_guard:
            self._guard_scan(active, logits)
        return logits

    def _nan_stat_lanes(self) -> np.ndarray:
        """(max_lanes,) bool: a NaN anywhere in the lane's streaming stats,
        any layer. The reference copies each lane's (m, l, acc) to the host
        (``_lane_stream_stats``, ``engine.py:1428``); here the test runs on
        the device and one flag per lane comes back (one sync)."""
        flags = None
        for name in STREAM_LEAVES:
            t = self.kv.storage[name]                       # (L, lanes, ...)
            bad = torch.isnan(t).flatten(2).any(2).any(0)
            flags = bad if flags is None else flags | bad
        return flags.cpu().numpy()

    def _guard_scan(self, active: list[int], logits: np.ndarray) -> None:
        """The numerics guard's ladder (``engine.py:984``): NaN streaming
        stats with finite logits quarantine the lane (every stats row
        reseeded exactly from its K/V) and the emit proceeds; non-finite
        logits replay-preempt it (the landmark sums moved this tick, so
        only a recompute is exact). ``numerics_demote_after`` trips demote
        a frozen request to the exact program for the rest of its life."""
        nan_lanes = None
        for i in active:
            lane = self.lanes[i]
            if lane.free:
                continue
            uid = lane.req.uid
            bad_logits = not bool(np.isfinite(logits[i, : self.cfg.vocab_size]).all())
            bad_stats = False
            if not bad_logits and self._streams:
                if nan_lanes is None:  # a reseed or preempt touches only its lane
                    nan_lanes = self._nan_stat_lanes()
                bad_stats = bool(nan_lanes[i])
            if not (bad_logits or bad_stats):
                continue
            trips = self._guard_trips.get(uid, 0) + 1
            self._guard_trips[uid] = trips
            if bad_stats and self._ensure_reseed_step():
                self._quarantines.inc()
                self.sched.flight.record(uid, "quarantine", tick=self._tick, lane=i,
                                         trips=trips)
                # lane.pos is still the position this tick's step wrote
                self._run_reseed(i, lane.pos)
            else:
                self.sched.preempt(i)
            if (trips >= self.serve.numerics_demote_after
                    and self.cfg.decode_streaming == "frozen"
                    and uid not in self._demoted):
                self._demoted.add(uid)
                self._demotions.inc()
                self.sched.flight.record(uid, "demote", tick=self._tick, trips=trips)

    # -- no-progress watchdog --------------------------------------------------
    def _watchdog_check(self) -> None:
        """After ``watchdog_ticks`` ticks with work pending and no progress
        (no token, no chunk, no admission), one rung per tick: reclaim a
        parked request's blocks, else preempt the youngest lane; past two
        sweeps of the lanes, raise ``EngineStalled`` (``engine.py:1033``)."""
        wd = self.serve.watchdog_ticks
        if wd <= 0:
            return
        if self._progress or self.sched.idle:
            if self._wd_fired_tick is not None:
                self._recovery_h.observe(self._tick - self._wd_fired_tick)
                self._wd_fired_tick = None
            self._stall_ticks = self._wd_interventions = 0
            return
        self._stall_ticks += 1
        if self._stall_ticks < wd:
            return
        self._wd_fires.inc()
        self.sched.flight.record(-1, "watchdog", tick=self._tick,
                                 stall_ticks=self._stall_ticks, rung=self._wd_interventions)
        if self._wd_fired_tick is None:
            self._wd_fired_tick = self._tick
        self._wd_interventions += 1
        # each intervention frees blocks or empties a lane, so needing more
        # than a full sweep of both rungs means the stall is structural
        if self._wd_interventions <= 2 * (self.max_lanes + 1):
            if self.sched.reclaim_parked():
                return
            victim = self.sched._youngest_lane()
            if victim is not None:
                self.sched.preempt(victim)
                return
        alloc = self.sched.allocator
        raise EngineStalled(
            tick=self._tick, stall_ticks=self._stall_ticks,
            waiting=len(self.sched.waiting),
            active_lanes=sum(u is not None for u in self.sched.lane_uid),
            parked=len(self.sched.parked),
            pool={} if alloc is None else alloc.stats())

    # -- frozen-mode boundary rebase -------------------------------------------
    def _rebase_hits(self, active: list[int]) -> list[int]:
        """Active lanes whose just-written position starts a new landmark
        segment, skipping retired lanes and demoted ones (the exact program
        has no drifting row)."""
        return [i for i in active
                if not self.lanes[i].free
                and self.lanes[i].req.uid not in self._demoted
                and self.lanes[i].pos - 1 > 0
                and (self.lanes[i].pos - 1) % self._seg == 0]

    def _run_rebase(self, hits: list[int]) -> None:
        """Rebase the given lanes (``engine.py:1399``): gather their views,
        recompute rows active - 1 and active, commit the stats; then the
        rebase counter, the flight events and the drift probe."""
        t0 = time.perf_counter()
        positions = np.zeros(self.max_lanes, np.int32)
        for i in hits:
            positions[i] = self.lanes[i].pos - 1
        # The reference's pre-rebase snapshot survives its functional
        # update; here the rebase commits in place (index_copy_), so the
        # probe's rows are copied (index_select: a new tensor, queued
        # before the rebase on the same stream), never viewed.
        pre = ({i: self._drift_rows(i, int(positions[i])) for i in hits}
               if self._drift_mon is not None else None)
        # fresh tables: retirements above freed blocks
        self._rebase_step(self.sched.tables(), positions, hits,
                          self.kv.view_blocks_needed(positions, hits))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rebase_s += time.perf_counter() - t0
        self.rebases += len(hits)
        self.telemetry.metrics.counter(
            "serve_rebases_total", help="frozen-mode boundary rebases").inc(len(hits))
        for i in hits:
            self.telemetry.flight.record(self.lanes[i].req.uid, "rebase", tick=self._tick,
                                         pos=int(positions[i]))
        if pre is not None:
            self._probe_rebase_drift(hits, positions, pre)

    def _drift_rows(self, i: int, p: int) -> tuple:
        """Copies of lane ``i``'s ``l`` and ``acc`` at the landmark rows the
        rebase at position ``p`` recomputes (j - 1 and j, j = p // seg): all
        the drift formula reads."""
        j = p // self._seg
        idx = torch.as_tensor([j - 1, j] if j > 0 else [j], device=self.device)
        return tuple(self.kv.storage[name][:, i].index_select(-2, idx)
                     for name in ("bv_l", "bv_acc"))

    def _lane_m_l(self, i: int) -> tuple:
        """Host copies of lane ``i``'s ``m`` and ``l`` (every layer), for the
        spectrum monitor."""
        return tuple(self.kv.storage[name][:, i].cpu().numpy() for name in ("bv_m", "bv_l"))

    def _probe_rebase_drift(self, hits, positions, pre) -> None:
        """The free residual probe (``engine.py:1438``): the rebase just
        recomputed the boundary rows exactly, so streamed (pre) against
        exact (post) on those rows is the frozen-mode drift, by the
        offline formula (``monitors.bv_row_residual``)."""
        for i in hits:
            p = int(positions[i])
            post = self._drift_rows(i, p)
            pl, pa = (t.cpu().numpy() for t in pre[i])
            ql, qa = (t.cpu().numpy() for t in post)
            self._drift_mon.observe(bv_row_residual((pl, pa), (ql, qa), range(pl.shape[-2])))
            if self._spectrum_mon is not None:
                m, l = self._lane_m_l(i)
                self._spectrum_mon.observe(m, l, min(p // self._seg + 1,
                                                     self.cfg.num_landmarks))

    # -- one engine tick -------------------------------------------------------
    def tick(self) -> None:
        with self.telemetry.span("serve_tick"), dispatch.use_tiling(self._prefill_block,
                                                                   self._chunk_slots):
            self._progress = False
            if self._chunked:
                self._tick_chunked()
            else:
                self._tick_two_phase()
            self._watchdog_check()

    def _begin_tick(self) -> None:
        """Advance the clock, fire the tick-scoped chaos sites, expire
        deadlines (``engine.py:1087``); with telemetry, count the tick and
        sample the counter tracks."""
        self._tick += 1
        self.sched.tick_now = self._tick
        if self.chaos is not None:
            self.chaos.begin_tick(self._tick)
            self._apply_tick_chaos()
        self._expire_deadlines()
        if self.telemetry.enabled:
            self._ticks_total.inc()
            fl = self.telemetry.flight
            fl.counter_sample("queue_depth", len(self.sched.waiting))
            alloc = self.sched.allocator
            if alloc is not None:
                fl.counter_sample("pool_blocks_used", alloc.num_used)
                fl.counter_sample("pool_fragmentation", alloc.fragmentation())

    def _sample_emit(self, active: list[int], logits: np.ndarray, firsts=()) -> None:
        """Advance every active lane that survived the checks: a chaos
        ``drop_sample`` replay-preempts it, token replay feeds its next
        prompt token, else its token is sampled and emitted. Then the first
        token of each prefill the chunked tick completed (``firsts``:
        (lane, host logits))."""
        with self.telemetry.span("sample_emit"):
            for i in active:
                lane = self.lanes[i]
                if lane.free:  # the guard replay-preempted it after the sync
                    continue
                if self.chaos is not None and self.chaos.fire("drop_sample", lane=i):
                    # the token is lost before commit: recover by replay
                    self.sched.preempt(i)
                    continue
                lane.pos += 1
                self.telemetry.flight.record(lane.req.uid, "decode", tick=self._tick,
                                             pos=lane.pos)
                if lane.prompt_left:  # token replay: ignore the sample
                    lane.next_token = lane.prompt_left.popleft()
                    continue
                self._emit_token(i, logits[i, : self.cfg.vocab_size])
            for i, lg in firsts:
                if self.lanes[i].free:  # cancelled mid-tick
                    continue
                if self._prefix_enabled:
                    # before the emit, which may retire the lane
                    self._maybe_cache_prefix(i, lg)
                self._emit_token(i, lg)

    def _rebase_after_emit(self, active: list[int]) -> None:
        if self._frozen_rebase:
            hits = self._rebase_hits(active)
            if hits:
                with self.telemetry.span("rebase", lanes=len(hits)):
                    self._run_rebase(hits)

    def _tick_two_phase(self) -> None:
        self._begin_tick()
        tel = self.telemetry
        with tel.span("admit"):
            admissions = self.sched.admit()
        if admissions:
            self._progress = True
        for i, req in admissions:
            lane = self.lanes[i] = _Lane(req=req)
            if self.batched and req.prompt:
                with tel.span("prefill", lane=i):
                    self._run_prefill(i, req)
            else:
                # token replay (``engine.py:1124``): the prompt goes through
                # the decode step one token per tick, from zeroed state
                self.kv.zero_lane_dense(i)
                lane.prompt_left = deque(req.prompt)
                lane.next_token = lane.prompt_left.popleft() if lane.prompt_left else 0

        # decode phase: every occupied lane not prefilled this very tick
        active = self._grow_decoders([i for i, l in enumerate(self.lanes)
                                      if not l.free and l.prefilled_tick != self._tick])
        if not active:
            return
        t0 = time.perf_counter()
        # Host spans at the reference's points, no sync added: on CUDA
        # decode_dispatch also waits wherever the step syncs (the commit's
        # torch.nonzero, pageable uploads), device_sync on the logits' copy.
        with tel.span("decode_dispatch", lanes=len(active)):
            parts = self._dispatch_decode(active)
        with tel.span("device_sync"):
            logits = self._merge_logits(parts)
        self.decode_s += time.perf_counter() - t0
        self.decode_ticks += 1
        logits = self._post_decode_checks(active, logits)
        self._sample_emit(active, logits)
        self._rebase_after_emit(active)

    def _tick_chunked(self) -> None:
        """One continuous-batching tick (``engine.py:1201``): decode
        dispatch first, then admissions (parked requests resume, prefix
        hits attach), then up to ``prefill_token_budget`` tokens of prompt
        chunks in admission order, then the all-prefill deadlock breaker,
        then the host sync at the sample boundary. Decode lanes advance
        every tick however much prefill is pending."""
        self._begin_tick()
        tel = self.telemetry
        t0 = time.perf_counter()
        active = self._grow_decoders([i for i, l in enumerate(self.lanes)
                                      if not l.free and not l.prefilling
                                      and l.prefilled_tick != self._tick])
        parts = []
        if active:
            with tel.span("decode_dispatch", lanes=len(active)):
                parts = self._dispatch_decode(active)

        # ---- admissions: parked requests resume at their chunk boundary --
        with tel.span("admit"):
            admissions = self.sched.admit()
        if admissions:
            self._progress = True
        for i, req in admissions:
            lane = self.lanes[i] = _Lane(req=req)
            parked = self._parked.pop(req.uid, None)
            if parked is not None:
                self.parked_resumes += 1
                self.kv.dense_restore(i, parked["snap"])
                lane.prefill_pos = parked["prefill_pos"]
                lane.chunk_idx = parked["chunk_idx"]
                lane.prefilling = True
            elif self._prefix_enabled and self._try_attach_prefix(i, req):
                pass  # the attach set the lane (full or partial hit)
            else:
                self.kv.zero_lane_dense(i)
                # an empty prompt goes straight to decode from position 0
                lane.prefilling = bool(req.prompt)

        # ---- chunks, FCFS by admission order, under the token budget ------
        max_chunks = max(1, (self.serve.prefill_token_budget or self._chunk)
                         // self._chunk)
        prefilling = sorted(
            (i for i, l in enumerate(self.lanes) if not l.free and l.prefilling),
            key=lambda i: self.sched.admit_order.get(self.lanes[i].req.uid, 0))
        firsts: list[tuple[int, torch.Tensor, int]] = []
        launched = 0
        bs = self.serve.block_size
        dispatching = True
        while dispatching:
            dispatching = False
            for i in prefilling:
                if launched >= max_chunks:
                    break
                lane = self.lanes[i]
                if lane.free:
                    continue  # preempted by the deadlock breaker this tick
                req, start = lane.req, lane.prefill_pos
                cv = min(self._chunk, len(req.prompt) - start)
                if not self.sched.ensure_prefill_blocks(i, start + cv):
                    continue  # pool dry: the chunk stalls, never evicts a decoder
                ctoks = np.zeros((1, self._chunk), np.int64)
                ctoks[0, :cv] = req.prompt[start:start + cv]
                # the table row sliced as the reference's is (``engine.py:1295``):
                # it spans the committed prefix and the chunk's slots
                row = self.sched.table_row(i)
                if self.kv.paged:
                    row = row[:bucket_view_slots(start // bs + self._chunk // bs,
                                                 self.serve.blocks_per_lane)]
                with tel.span("prefill_chunk", lane=i, chunk=lane.chunk_idx):
                    lg = self._chunk_step(row, torch.as_tensor(ctoks, device=self.device),
                                          i, start, cv)
                tel.flight.record(req.uid, "prefill_chunk", tick=self._tick,
                                  chunk=lane.chunk_idx, tok0=start, tok1=start + cv, lane=i)
                lane.prefill_pos = start + cv
                lane.chunk_idx += 1
                launched += 1
                if lane.prefill_pos >= len(req.prompt):
                    lane.prefilling = False
                    lane.pos = len(req.prompt)
                    lane.prefilled_tick = self._tick
                    firsts.append((i, lg, cv))
                elif self._prefix_enabled and lane.prefill_pos % bs == 0:
                    # a partial-hit resume point (a host copy: syncs)
                    lane.stat_points[lane.prefill_pos] = self.kv.dense_snapshot(i)
            # Every held lane stalled mid-prefill on a dry pool with no
            # decoder whose retirement could free blocks: preempt the
            # youngest stalled prefill and retry within this tick, so the
            # FCFS head reclaims the victim's parked blocks first.
            if not launched:
                stalled = [i for i in prefilling if not self.lanes[i].free]
                decoding = any(not l.free and not l.prefilling for l in self.lanes)
                if len(stalled) > 1 and not decoding and not self.sched.parked:
                    self.sched.preempt(stalled[-1])
                    dispatching = True
        if launched:
            self._progress = True

        # ---- the sample boundary: one sync for every logits row ----------
        with tel.span("device_sync"):
            logits = self._merge_logits(parts)
            firsts = [(i, lg[0, cv - 1, : self.cfg.vocab_size].float().cpu().numpy())
                      for i, lg, cv in firsts]
        logits = self._post_decode_checks(active, logits)
        self._sample_emit(active, logits, firsts)
        self._rebase_after_emit(active)

        self.decode_ticks += bool(active)
        self.chunks += launched
        dt = time.perf_counter() - t0
        if launched:
            self.chunk_ticks += 1
            self.chunk_tick_s += dt
        elif active:
            self.plain_ticks += 1
            self.plain_tick_s += dt
