"""Serving engine: paged KV cache + two-phase scheduler over spectral-shift
decode (``repro/serve/engine.py``, the two-phase tick ``_tick_inner``).

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
first divergent write. Frozen streaming, telemetry, chaos, deadlines,
``max_queue``, the numerics guard and the watchdog are not ported; the
constructor rejects them.

Host syncs of the chunked tick on CUDA, besides the one at the sample
boundary: the decode step's commit (``PagedKVCache._commit``,
``torch.nonzero``), every upload of a host array (tables, tokens,
positions: pageable copies), and the stat-point snapshots taken while a
prefill runs with the prefix cache on. The first means chunk dispatch
does not overlap the decode step.

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
from repro_torch.kernels import MAX_HEAD_DIM
from repro_torch.models.model import working_params
from repro_torch.serve.decode import decode_step
from repro_torch.serve.decode_state import make_reseed_fn
from repro_torch.serve.paged import BlockAllocator, PagedKVCache, PrefixCache
from repro_torch.serve.prefill import batched_prefill, make_chunk_prefill_fn
from repro_torch.serve.scheduler import Scheduler


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 => greedy
    # streamed-token callback: on_token(uid, token) fires as each token is
    # sampled, inside the tick
    on_token: Optional[object] = None


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


def _check_supported(cfg: ModelConfig, serve: ServeConfig, device: torch.device) -> None:
    unsupported = {
        "family != 'dense'": cfg.family != "dense" or cfg.mla or cfg.moe,
        "decode_streaming='frozen'": cfg.decode_streaming not in ("exact", "recompute"),
        "telemetry": serve.telemetry,
        "numerics_guard": serve.numerics_guard,
        "max_queue": serve.max_queue > 0,
        "watchdog_ticks": serve.watchdog_ticks > 0,
        # every kernel takes head dims up to MAX_HEAD_DIM (not MLA's
        # 576/512): refused here, not on the first tick
        f"head_dim {cfg.resolved_head_dim} > {MAX_HEAD_DIM} on CUDA":
            device.type == "cuda" and cfg.resolved_head_dim > MAX_HEAD_DIM,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *,
                 serve: Optional[ServeConfig] = None, device="cuda"):
        serve = serve or ServeConfig()
        self.device = resolve_device(device)
        _check_supported(cfg, serve, self.device)
        self.cfg, self.serve = cfg, serve
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
        # (silently off otherwise, ``engine.py:180``).
        self._prefix_enabled = serve.prefix_cache and self.kv.paged
        self._chunked = serve.chunked_prefill or self._prefix_enabled
        # chunk rounded up to a block multiple: chunk starts stay aligned
        bs = serve.block_size
        self._chunk = min(-(-serve.prefill_chunk_tokens // bs) * bs, self.max_seq)
        self.sched = Scheduler(alloc, self.max_lanes, serve.blocks_per_lane,
                               chunk_tokens=self._chunk if self._chunked else 0)
        self.sched.requeue_cb = self._on_preempt
        if self._chunked:
            self.sched.park_cb = self._park_lane
            self.sched.park_drop_cb = self._drop_parked
        self._parked: dict[int, dict] = {}  # uid -> snapshot + progress
        self.prefix = None
        if self._prefix_enabled:
            self.prefix = PrefixCache(alloc, max_blocks=serve.prefix_cache_blocks)
            self.sched.prefix_probe = self._prefix_probe
            self.sched.cow_cb = self.kv.copy_block
            self._probe_pins: dict[int, object] = {}  # uid -> soft-pinned entry
        # Decode route (``engine.py:296-328``): recompute-mode spectral shift
        # rebuilds the dense B matrix, so only the gather route serves it.
        paged_ok = self.kv.paged and not (
            cfg.decode_attention_impl == "spectral_shift"
            and cfg.decode_streaming == "recompute")
        self.decode_impl = ("paged" if serve.decode_impl == "paged" and paged_ok
                            else "gather")
        if self.decode_impl == "paged":
            self._step = self.kv.make_paged_step(
                lambda cache, tokens, table: decode_step(
                    self.params, cfg, cache, tokens, seq_max=self.max_seq,
                    paged_table=table, block_size=bs))
        else:
            self._step = self.kv.make_fused_step(
                lambda cache, tokens: decode_step(self.params, cfg, cache, tokens,
                                                  seq_max=self.max_seq))
        self.batched = serve.batched_prefill
        if self._chunked:
            self._chunk_step = self.kv.make_chunk_step(
                make_chunk_prefill_fn(self.params, cfg, seq_max=self.max_seq,
                                      stats_impl=serve.prefill_impl), self._chunk)
        # "recompute" attach: every stats row re-derived from the shared K/V
        self._reseed_step = None
        if (self._prefix_enabled and serve.prefix_attach == "recompute"
                and cfg.decode_attention_impl == "spectral_shift"
                and cfg.decode_streaming == "exact"):
            self._reseed_step = self.kv.make_rebase_step(
                make_reseed_fn(cfg, self.max_seq))
        # bucket rounded up to a block multiple so prefill writes whole blocks
        self._bucket = -(-serve.prefill_bucket // bs) * bs

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_seq:
            raise ValueError(
                f"prompt len {len(req.prompt)} >= max_seq {self.max_seq}")
        self.sched.submit(req)

    def run(self, max_ticks: int = 10_000) -> dict[int, list[int]]:
        """Drive until queue and lanes drain (or the tick budget)."""
        for _ in range(max_ticks):
            if self.sched.idle:
                break
            self.tick()
        return self.finished

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
            decode_impl=self.decode_impl,
            decode_streaming=self.cfg.decode_streaming)
        if self.prefix is not None:
            st["prefix"] = self.prefix.stats()
        return st

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
                                      "prefill_pos": lane.prefill_pos}
        self.parks += 1
        return True

    def _drop_parked(self, uid: int) -> None:
        """A parked request's blocks were reclaimed: it recomputes."""
        self._parked.pop(uid, None)

    def _retire(self, i: int) -> None:
        lane = self.lanes[i]
        self.finished[lane.req.uid] = list(lane.generated)
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
        self.prefix.note_hit(entry)
        self.sched.mark_prefix_hit(req.uid)
        if self._reseed_step is not None:
            self._run_reseed(i, n_attach - 1)
        if full:
            self._emit_token(i, np.asarray(entry.logits, np.float32))
        return True

    def _run_reseed(self, i: int, last_pos: int) -> None:
        """The reseed attach for one lane (``engine.py:721``): every reached
        stats row recomputed over the lane's shared K/V."""
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
        logits, pcache = batched_prefill(
            self.params, self.cfg, tokens.to(self.device), n,
            seq_max=self.max_seq, prefill_impl=self.serve.prefill_impl)
        self.kv.write_prefill(i, pcache, self.sched.table_row(i), n_tokens=n)
        lane.pos = n
        lane.prefilled_tick = self._tick
        lg = logits[0, n - 1, : self.cfg.vocab_size].float().cpu().numpy()
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
        self.sched.note_token(lane.req.uid)
        if lane.req.on_token is not None:
            lane.req.on_token(lane.req.uid, tok)
        if (tok == self.eos_id or len(lane.generated) >= lane.req.max_new_tokens
                or lane.pos + 1 >= self.max_seq):
            self._retire(i)
        else:
            lane.next_token = tok

    # -- decode dispatch -------------------------------------------------------
    def _dispatch_decode(self, active: list[int]) -> torch.Tensor:
        """One batched decode step for all lanes (inactive lanes run masked
        and commit nothing). Returns the device logits (max_lanes, 1, V)
        without syncing on them."""
        tokens = np.zeros((self.max_lanes, 1), np.int64)
        positions = np.zeros(self.max_lanes, np.int32)
        mask = np.zeros(self.max_lanes, bool)
        for i in active:
            tokens[i, 0] = self.lanes[i].next_token
            positions[i] = self.lanes[i].pos
            mask[i] = True
        dev = self.device
        args = [torch.as_tensor(self.sched.tables(), device=dev),
                torch.as_tensor(tokens, device=dev),
                torch.as_tensor(positions, device=dev),
                torch.as_tensor(mask, device=dev)]
        if self.decode_impl == "gather":
            args.append(self.kv.view_blocks_needed(positions, active))
        return self._step(*args)

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

    # -- one engine tick -------------------------------------------------------
    def tick(self) -> None:
        self._tick += 1
        self.sched.tick_now = self._tick
        if self._chunked:
            return self._tick_chunked()
        for i, req in self.sched.admit():
            lane = self.lanes[i] = _Lane(req=req)
            if self.batched and req.prompt:
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
        logits = self._dispatch_decode(active)[:, 0].float().cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        self.decode_ticks += 1
        for i in active:
            lane = self.lanes[i]
            lane.pos += 1
            if lane.prompt_left:  # token replay: ignore the sample
                lane.next_token = lane.prompt_left.popleft()
                continue
            self._emit_token(i, logits[i, : self.cfg.vocab_size])

    def _tick_chunked(self) -> None:
        """One continuous-batching tick (``engine.py:1201``): decode
        dispatch first, then admissions (parked requests resume, prefix
        hits attach), then up to ``prefill_token_budget`` tokens of prompt
        chunks in admission order, then the all-prefill deadlock breaker,
        then the host sync at the sample boundary. Decode lanes advance
        every tick however much prefill is pending."""
        t0 = time.perf_counter()
        active = self._grow_decoders([i for i, l in enumerate(self.lanes)
                                      if not l.free and not l.prefilling
                                      and l.prefilled_tick != self._tick])
        dev_logits = self._dispatch_decode(active) if active else None

        # ---- admissions: parked requests resume at their chunk boundary --
        for i, req in self.sched.admit():
            lane = self.lanes[i] = _Lane(req=req)
            parked = self._parked.pop(req.uid, None)
            if parked is not None:
                self.parked_resumes += 1
                self.kv.dense_restore(i, parked["snap"])
                lane.prefill_pos = parked["prefill_pos"]
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
                lg = self._chunk_step(self.sched.table_row(i),
                                      torch.as_tensor(ctoks, device=self.device),
                                      i, start, cv)
                lane.prefill_pos = start + cv
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

        # ---- the sample boundary: one sync for every logits row ----------
        logits = (dev_logits[:, 0].float().cpu().numpy()
                  if dev_logits is not None else None)
        firsts = [(i, lg[0, cv - 1, : self.cfg.vocab_size].float().cpu().numpy())
                  for i, lg, cv in firsts]
        for i in active:
            lane = self.lanes[i]
            if lane.free:
                continue
            lane.pos += 1
            self._emit_token(i, logits[i, : self.cfg.vocab_size])
        for i, lg in firsts:
            if self._prefix_enabled:
                # before the emit, which may retire the lane
                self._maybe_cache_prefix(i, lg)
            self._emit_token(i, lg)

        self.decode_ticks += bool(active)
        self.chunks += launched
        dt = time.perf_counter() - t0
        if launched:
            self.chunk_ticks += 1
            self.chunk_tick_s += dt
        elif active:
            self.plain_ticks += 1
            self.plain_tick_s += dt
