"""Block-paged KV cache (``repro/serve/paged.py``, the parts the two-phase
engine uses).

* ``BlockAllocator``: host-side free list of fixed-size token blocks with
  per-request block tables. Block 0 (``ZERO_BLOCK``) is reserved: it backs
  unallocated table slots and is never handed out.
* ``PagedKVCache``: device storage. With ``ServeConfig.paged`` the
  sequence-shaped leaves ``k``/``v`` live in shared pools (L, Hkv,
  num_blocks, block_size, Dh); everything else is lane-dense (L,
  max_lanes, ...). With ``paged=False`` every leaf is lane-dense, K/V
  (L, max_lanes, Hkv, max_seq, Dh): the reference's seed-engine layout.
  Storage is updated IN PLACE (``index_copy_`` / ``index_put_``) where the
  reference donates buffers to a jitted program: ``write_prefill``
  installs a prefill result, and both decode ticks commit the new token
  (into one block row per lane, or the lane's dense row) and the
  lane-dense leaves of the active lanes.
* Two decode ticks, as in the reference: ``make_paged_step`` (gather-free,
  kernel K5 reads the pools) and ``make_fused_step`` (the gather route:
  dense per-lane views ``view_blocks_needed`` long, gathered from the pools
  by ``gather_views``, or the lane-dense storage itself).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.serve.kv_cache import cache_leaf_layout

ZERO_BLOCK = 0


def bucket_view_slots(need: int, cap: int, quantum: int = 0) -> int:
    """Round a required block-table slot count up to a bucket
    (``paged.py:61``): the next power of two, or the next multiple of
    ``quantum`` when it is > 0, capped at ``cap``."""
    if quantum > 0:
        return min(-(-need // quantum) * quantum, cap)
    nb = 1
    while nb < need:
        nb *= 2
    return min(nb, cap)


class BlockAllocator:
    """Free-list allocator of fixed-size token blocks with per-request
    block tables (no sharing: every block belongs to one table)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block past block 0")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list (recently freed blocks are reused first); block 0
        # excluded. Same order as the reference, so tables match it.
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self.tables: dict[int, list[int]] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def alloc(self, uid: int, n_blocks: int) -> Optional[list[int]]:
        """Append ``n_blocks`` fresh blocks to ``uid``'s table; None (no
        state change) if the pool is short."""
        if n_blocks > self.num_free:
            return None
        got = [self._free.pop() for _ in range(n_blocks)]
        self.tables.setdefault(uid, []).extend(got)
        return got

    def free(self, uid: int) -> list[int]:
        """Return every block of ``uid``'s table to the free list."""
        blocks = self.tables.pop(uid, [])
        self._free.extend(reversed(blocks))
        return blocks


class PagedKVCache:
    """Device storage for one engine's decode state: pools for ``k``/``v``
    (``paged=True``) or lane-dense K/V (``paged=False``), lane-dense
    tensors for the landmark sums and the streaming stats. ``storage``
    maps leaf name -> tensor; ``pool_names`` are the pooled leaves,
    ``seq_names`` the sequence-shaped ones either way."""

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, device):
        self.cfg, self.serve = cfg, serve
        self.block_size = serve.block_size
        self.max_lanes, self.max_seq = serve.max_lanes, serve.max_seq
        self.num_blocks = serve.resolved_num_blocks
        self.paged = serve.paged
        self.pool_names, self.dense_names, self.seq_names = [], [], []
        self.storage: dict[str, torch.Tensor] = {}
        for path, spec, seq_axis in cache_leaf_layout(cfg, serve.max_seq):
            name = path.rsplit("/", 1)[-1]
            if name == "pos":
                continue
            # stacked layer leaf: (L, B=1, *rest); the batch axis is 1
            layers, rest = spec.shape[0], spec.shape[2:]
            dt = spec.dtype or torch.float32
            if seq_axis is not None:
                self.seq_names.append(name)
            if seq_axis is not None and self.paged:
                j = seq_axis - 2          # seq position within rest
                shape = (layers, *rest[:j], self.num_blocks, self.block_size,
                         *rest[j + 1:])
                self.pool_names.append(name)
            else:
                shape = (layers, self.max_lanes, *rest)
                self.dense_names.append(name)
            self.storage[name] = torch.zeros(shape, dtype=dt, device=device)

    def write_prefill(self, lane: int, prefill_cache: dict,
                      table_row: np.ndarray, n_tokens: int) -> None:
        """Install a batched-prefill result (B=1 cache, seq leaves n_pad
        long) into ``lane`` in place: the first ceil(n_tokens / bs) blocks
        of each pooled leaf go to the lane's allocated blocks (positions
        past n_tokens are zero), dense leaves overwrite the lane's slots
        (a dense K/V leaf zero-padded to max_seq)."""
        bs = self.block_size
        nb = -(-n_tokens // bs)
        layers = prefill_cache["layers"]
        for name in self.pool_names:
            pool = self.storage[name]                     # (L, Hkv, NB, bs, Dh)
            leaf = layers[name][:, 0]                     # (L, Hkv, n_pad, Dh)
            pad = -leaf.shape[2] % bs
            if pad:  # unpadded <= c prompts are not a block multiple
                leaf = torch.nn.functional.pad(leaf, (0, 0, 0, pad))
            split = leaf.reshape(*leaf.shape[:2], -1, bs, leaf.shape[-1])
            ids = torch.as_tensor(np.asarray(table_row[:nb], np.int64),
                                  device=pool.device)
            pool.index_copy_(2, ids, split[:, :, :nb].to(pool.dtype))
        for name in self.dense_names:
            leaf = layers[name][:, 0]
            dst = self.storage[name][:, lane]
            if name in self.seq_names:                    # (L, Hkv, n_pad, Dh)
                dst.zero_()
                dst[:, :, :leaf.shape[2]] = leaf.to(dst.dtype)
            else:
                dst.copy_(leaf)

    def zero_lane_dense(self, lane: int) -> None:
        """Fresh-request reset of a lane's lane-dense state
        (``paged.py:1006``): the token-replay prefill starts from zeros."""
        for name in self.dense_names:
            self.storage[name][:, lane].zero_()

    def view_blocks_needed(self, positions, lanes, quantum: int = 0) -> int:
        """Bucketed block count covering the deepest active position
        (``paged.py:994``): the gather route's view length, in blocks."""
        cap = self.max_seq // self.block_size
        if not self.paged or not lanes:
            return cap
        need = max(int(positions[i]) // self.block_size + 1 for i in lanes)
        return bucket_view_slots(need, cap, quantum)

    def _gather_leaf(self, pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
        """Pool (L, Hkv, NB, bs, Dh) + tables (rows, nb) -> the rows' dense
        views (L, rows, Hkv, nb * bs, Dh) (``paged.py:618``)."""
        g = pool[:, :, tables.long()]                     # (L, Hkv, rows, nb, bs, Dh)
        layers, hkv, rows, nb, bs, dh = g.shape
        return g.permute(0, 2, 1, 3, 4, 5).reshape(layers, rows, hkv, nb * bs, dh)

    def gather_views(self, tables: torch.Tensor) -> dict:
        """tables (max_lanes, n_view_blocks) int32, ZERO_BLOCK where
        unallocated -> every leaf lane-stacked and dense (``paged.py:632``):
        pooled leaves gathered (L, max_lanes, Hkv, n_view_blocks * bs, Dh),
        the others as stored."""
        return {name: self._gather_leaf(t, tables) if name in self.pool_names else t
                for name, t in self.storage.items()}

    def _commit(self, new_layers: list, tables, positions, active) -> None:
        """Write, for active lanes only and in place, each layer's new token
        K/V into its row (a block row of the pool, or the lane's dense row
        at its position) and the lane-dense leaves."""
        bs = self.block_size
        lanes = torch.nonzero(active).squeeze(1)
        pos = positions.long()[lanes]
        if self.pool_names:
            blocks = tables.long()[lanes, pos // bs]
            offs = pos % bs
        for i, new in enumerate(new_layers):
            for name in self.seq_names:
                vals = new[name][lanes, :, 0]             # (A, Hkv, Dh)
                if name in self.pool_names:
                    pool = self.storage[name][i]          # (Hkv, NB, bs, Dh)
                    pool[:, blocks, offs] = vals.transpose(0, 1).to(pool.dtype)
                else:
                    dense = self.storage[name][i]         # (lanes, Hkv, S, Dh)
                    dense[lanes, :, pos] = vals.to(dense.dtype)
            for name in self.dense_names:
                if name not in self.seq_names:
                    self.storage[name][i].index_copy_(
                        0, lanes, new[name][lanes].to(self.storage[name].dtype))

    def make_paged_step(self, decode_step_fn):
        """The gather-free decode tick (``paged.py:750``):
        ``decode_step_fn(cache, tokens, table) -> (logits, new_cache)`` is
        the paged decode step (``serve/decode.py``). Returns
        ``fn(tables, tokens, positions, active) -> logits`` (all device
        tensors: tables (lanes, n_slots) int32, tokens (lanes, 1),
        positions (lanes,) int32, active (lanes,) bool) that runs the step
        for every lane and commits, for active lanes only and in place, the
        new token's K/V into its block row and the lane-dense leaves."""

        def fn(tables, tokens, positions, active):
            cache = {"pos": positions, "layers": self.storage}
            logits, new_cache = decode_step_fn(cache, tokens, tables)
            self._commit(new_cache["layers"], tables, positions, active)
            return logits

        return fn

    def make_fused_step(self, decode_step_fn):
        """The gather route's decode tick (``paged.py:683``): gather dense
        lane views from the pools (``n_view_blocks`` blocks long; the
        lane-dense storage as it is when ``paged=False``), run
        ``decode_step_fn(cache, tokens) -> (logits, new_cache)`` for every
        lane, then commit as ``make_paged_step`` does. Returns
        ``fn(tables, tokens, positions, active, n_view_blocks) -> logits``."""

        def fn(tables, tokens, positions, active, n_view_blocks):
            views = self.gather_views(tables[:, :n_view_blocks])
            logits, new_cache = decode_step_fn({"pos": positions, "layers": views},
                                               tokens)
            del views
            self._commit(new_cache["layers"], tables, positions, active)
            return logits

        return fn
