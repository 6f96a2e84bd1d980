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
in the reference as here. Chunked prefill, prefix caching, frozen
streaming, telemetry, chaos, deadlines, ``max_queue``, the numerics guard
and the watchdog are not ported; the constructor rejects them.

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
from repro_torch.serve.paged import BlockAllocator, PagedKVCache
from repro_torch.serve.prefill import batched_prefill
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
        "chunked_prefill": serve.chunked_prefill,
        "prefix_cache": serve.prefix_cache,
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
        # ends in a host sync on its logits, so these are device-inclusive)
        self.prefill_s = self.decode_s = 0.0
        self.decode_ticks = 0

        self.kv = PagedKVCache(cfg, serve, self.device)
        alloc = (BlockAllocator(serve.resolved_num_blocks, serve.block_size)
                 if self.kv.paged else None)
        self.sched = Scheduler(alloc, self.max_lanes, serve.blocks_per_lane)
        self.sched.requeue_cb = self._on_preempt
        # Decode route (``engine.py:296-328``): recompute-mode spectral shift
        # rebuilds the dense B matrix, so only the gather route serves it.
        paged_ok = self.kv.paged and not (
            cfg.decode_attention_impl == "spectral_shift"
            and cfg.decode_streaming == "recompute")
        self.decode_impl = ("paged" if serve.decode_impl == "paged" and paged_ok
                            else "gather")
        bs = serve.block_size
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
        s = self.sched
        ttft = [t.ttft_s for t in s.timing.values() if t.ttft_s is not None]
        mode = (f"{'paged' if self.kv.paged else 'dense'}"
                f"+{'batched' if self.batched else 'replay'}-prefill")
        return {"admitted": s.admitted, "finished": s.finished,
                "preemptions": s.preemptions, "tokens": s.tokens,
                "ttft_s": ttft, "ticks": self._tick,
                "prefill_s": self.prefill_s, "decode_s": self.decode_s,
                "decode_ticks": self.decode_ticks, "mode": mode,
                "decode_impl": self.decode_impl,
                "decode_streaming": self.cfg.decode_streaming}

    # -- scheduling hooks ------------------------------------------------------
    def _on_preempt(self, lane_idx: int) -> Optional[Request]:
        req = self.lanes[lane_idx].req
        self.lanes[lane_idx] = _Lane()
        return req

    def _retire(self, i: int) -> None:
        lane = self.lanes[i]
        self.finished[lane.req.uid] = list(lane.generated)
        self.sched.release(i)
        self.lanes[i] = _Lane()

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
    def _dispatch_decode(self, active: list[int]) -> np.ndarray:
        """One batched decode step for all lanes (inactive lanes run masked
        and commit nothing). Returns host logits (max_lanes, V)."""
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
        logits = self._step(*args)
        return logits[:, 0].float().cpu().numpy()

    # -- one engine tick -------------------------------------------------------
    def tick(self) -> None:
        self._tick += 1
        self.sched.tick_now = self._tick
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
        candidates = [i for i, l in enumerate(self.lanes)
                      if not l.free and l.prefilled_tick != self._tick]
        # grow block tables (may preempt, youngest first); a lane whose own
        # request was preempted (or cannot grow) drops out of the step
        active = []
        for i in candidates:
            if self.lanes[i].free:  # preempted as a victim earlier this loop
                continue
            if self.sched.ensure_block(i, self.lanes[i].pos):
                active.append(i)
        active = [i for i in active if not self.lanes[i].free]
        if not active:
            return
        t0 = time.perf_counter()
        logits = self._dispatch_decode(active)
        self.decode_s += time.perf_counter() - t0
        self.decode_ticks += 1
        for i in active:
            lane = self.lanes[i]
            lane.pos += 1
            if lane.prompt_left:  # token replay: ignore the sample
                lane.next_token = lane.prompt_left.popleft()
                continue
            self._emit_token(i, logits[i, : self.cfg.vocab_size])
