"""Block-paged KV cache (``repro/serve/paged.py``, the parts the two-phase
engine uses).

* ``BlockAllocator``: host-side free list of fixed-size token blocks with
  per-request block tables. Block 0 (``ZERO_BLOCK``) is reserved: it backs
  unallocated table slots and is never handed out.
* ``PagedKVCache``: device storage. The sequence-shaped leaves ``k``/``v``
  live in shared pools (L, Hkv, num_blocks, block_size, Dh); everything
  else is lane-dense (L, max_lanes, ...). Storage is updated IN PLACE
  (``index_copy_`` / ``index_put_``) where the reference donates buffers to
  a jitted program: ``write_prefill`` installs a prefill result and the
  paged decode tick commits the new token into one block row per lane.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.serve.kv_cache import cache_leaf_layout

ZERO_BLOCK = 0


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
    """Block-pool device storage for one engine's decode state: pools for
    ``k``/``v``, lane-dense tensors for the landmark sums and the
    streaming stats. ``storage`` maps leaf name -> tensor."""

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, device):
        if not serve.paged:
            raise NotImplementedError("lane-dense (paged=False) caches are not ported")
        self.cfg, self.serve = cfg, serve
        self.block_size = serve.block_size
        self.max_lanes, self.max_seq = serve.max_lanes, serve.max_seq
        self.num_blocks = serve.resolved_num_blocks
        self.pool_names, self.dense_names = [], []
        self.storage: dict[str, torch.Tensor] = {}
        for path, spec, seq_axis in cache_leaf_layout(cfg, serve.max_seq):
            name = path.rsplit("/", 1)[-1]
            if name == "pos":
                continue
            # stacked layer leaf: (L, B=1, *rest); the batch axis is 1
            layers, rest = spec.shape[0], spec.shape[2:]
            dt = spec.dtype or torch.float32
            if seq_axis is not None:
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
        of each seq leaf go to the lane's allocated blocks (positions past
        n_tokens are zero), dense leaves overwrite the lane's slots."""
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
            self.storage[name][:, lane].copy_(layers[name][:, 0])

    def make_paged_step(self, decode_step_fn):
        """The gather-free decode tick (``paged.py:750``):
        ``decode_step_fn(cache, tokens, table) -> (logits, new_cache)`` is
        the paged decode step (``serve/decode.py``). Returns
        ``fn(tables, tokens, positions, active) -> logits`` (all device
        tensors: tables (lanes, n_slots) int32, tokens (lanes, 1),
        positions (lanes,) int32, active (lanes,) bool) that runs the step
        for every lane and commits, for active lanes only and in place, the
        new token's K/V into its block row and the lane-dense leaves."""
        bs = self.block_size

        def fn(tables, tokens, positions, active):
            cache = {"pos": positions, "layers": self.storage}
            logits, new_cache = decode_step_fn(cache, tokens, tables)
            lanes = torch.nonzero(active).squeeze(1)
            pos = positions.long()[lanes]
            blocks = tables.long()[lanes, pos // bs]
            offs = pos % bs
            for i, new in enumerate(new_cache["layers"]):
                for name in self.pool_names:
                    pool = self.storage[name][i]          # (Hkv, NB, bs, Dh)
                    vals = new[name][lanes, :, 0]         # (A, Hkv, Dh)
                    pool[:, blocks, offs] = vals.transpose(0, 1).to(pool.dtype)
                for name in self.dense_names:
                    self.storage[name][i].index_copy_(
                        0, lanes, new[name][lanes].to(self.storage[name].dtype))
            return logits

        return fn
