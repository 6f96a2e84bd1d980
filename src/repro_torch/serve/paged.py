"""Block-paged KV cache (``repro/serve/paged.py``).

* ``BlockAllocator``: host-side free list of fixed-size token blocks with
  per-request block tables and a refcount per block (one per table that
  maps it, one per prefix-cache entry that retains it). Block 0
  (``ZERO_BLOCK``) is reserved: it backs unallocated table slots and is
  never handed out. ``attach_shared`` maps cached blocks into a table,
  ``cow`` breaks the sharing of one slot before a divergent write,
  ``defragment`` compacts the live blocks onto the lowest ids (shared
  blocks stay pinned in place).
* ``PrefixCache``: the content-hash index of cached prompt prefixes over
  the pool (chained SHA-1 digests per full block, first insert wins, LRU
  with soft pins and cascade eviction of cache-only entries).
* ``PagedKVCache``: device storage. With ``ServeConfig.paged`` the
  sequence-shaped leaves ``k``/``v`` live in shared pools (L, Hkv,
  num_blocks, block_size, Dh); everything else is lane-dense (L,
  max_lanes, ...). With ``paged=False`` every leaf is lane-dense, K/V
  (L, max_lanes, Hkv, max_seq, Dh): the reference's seed-engine layout.
  Storage is updated IN PLACE (``index_copy_`` / ``index_put_``) where the
  reference donates buffers to a jitted program: ``write_prefill``
  installs a prefill result, both decode ticks commit the new token (into
  one block row per lane, or the lane's dense row) and the lane-dense
  leaves of the active lanes, a chunk step commits a prompt chunk,
  ``copy_block`` is copy-on-write's device half, ``apply_mapping``
  permutes the pools after a defragmentation.
* Two decode ticks, as in the reference: ``make_paged_step`` (gather-free,
  kernel K5 reads the pools) and ``make_fused_step`` (the gather route:
  dense per-lane views ``view_blocks_needed`` long, gathered from the pools
  by ``gather_views``, or the lane-dense storage itself); the chunked
  prefill step ``make_chunk_step``; ``make_rebase_step``, which runs the
  frozen-mode boundary rebase and the stats reseed (the prefix cache's
  recompute attach, the numerics guard's quarantine).

The chaos sites of ``serve/chaos.py`` that live here: ``alloc_fail`` in
``BlockAllocator._take_free``, ``fragment`` (``scramble_free``, which
the engine calls) and ``hash_collision`` in ``PrefixCache.match``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.serve.decode_state import STREAM_LEAVES
from repro_torch.serve.kv_cache import layer_leaves, storage_layout
from repro_torch.telemetry.metrics import TICK_BUCKETS, MetricsRegistry

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
    block tables and per-block refcounts (``paged.py:83``). Invariant:
    every id in 1..num_blocks-1 is either on the free list or held at
    refcount >= 1, and re-enters the free list only when its count drops
    to zero."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block past block 0")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list (recently freed blocks are reused first); block 0
        # excluded. Same order as the reference, so tables match it.
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self.tables: dict[int, list[int]] = {}
        self.refcounts: dict[int, int] = {}
        # set by PrefixCache: evicts cache-only entries on a shortfall
        self.prefix_cache: Optional["PrefixCache"] = None
        # set by the engine: a ChaosInjector ("alloc_fail")
        self.chaos = None

    # -- queries ------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_alloc(self, n_blocks: int) -> bool:
        avail = self.num_free
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable_blocks()
        return n_blocks <= avail

    def refcount(self, block: int) -> int:
        return self.refcounts.get(block, 0)

    def fragmentation(self) -> float:
        """1 minus the longest contiguous run of free ids over the free
        count (0 when the free space is one run, or empty)."""
        if not self._free:
            return 0.0
        ids = sorted(self._free)
        best = run = 1
        for a, b in zip(ids, ids[1:]):
            run = run + 1 if b == a + 1 else 1
            best = max(best, run)
        return 1.0 - best / len(ids)

    def stats(self) -> dict:
        usable = self.num_blocks - 1
        return {"num_blocks": usable, "blocks_used": self.num_used,
                "blocks_free": self.num_free,
                "blocks_shared": sum(1 for rc in self.refcounts.values() if rc > 1),
                "utilization": self.num_used / max(usable, 1),
                "fragmentation": self.fragmentation(),
                "requests": len(self.tables)}

    # -- mutation -----------------------------------------------------------
    def _take_free(self, n_blocks: int) -> Optional[list[int]]:
        """Pop ``n_blocks`` at refcount 1, evicting reclaimable prefix-cache
        entries (LRU) to cover a shortfall; None if still short (or when
        the chaos ``alloc_fail`` site fires)."""
        if self.chaos is not None and self.chaos.fire("alloc_fail"):
            return None
        while n_blocks > self.num_free:
            if self.prefix_cache is None or not self.prefix_cache.evict_one(
                    reclaim_only=True):
                return None
        got = [self._free.pop() for _ in range(n_blocks)]
        for b in got:
            self.refcounts[b] = 1
        return got

    def alloc(self, uid: int, n_blocks: int) -> Optional[list[int]]:
        """Append ``n_blocks`` fresh blocks to ``uid``'s table; None (no
        state change beyond evictions) if the pool is short."""
        got = self._take_free(n_blocks)
        if got is None:
            return None
        self.tables.setdefault(uid, []).extend(got)
        return got

    def free(self, uid: int) -> list[int]:
        """Drop ``uid``'s reference on every block of its table; blocks
        whose count reaches zero return to the free list (returned)."""
        freed = []
        for b in reversed(self.tables.pop(uid, [])):
            if self.release_ref(b):
                freed.append(b)
        return freed

    def take_ref(self, block: int) -> None:
        """Add a reference to a resident block (never a free one)."""
        if block not in self.refcounts:
            raise ValueError(f"take_ref on free block {block}")
        self.refcounts[block] += 1

    def release_ref(self, block: int) -> bool:
        """Drop one reference; True if the block was freed."""
        rc = self.refcounts[block] - 1
        if rc:
            self.refcounts[block] = rc
            return False
        del self.refcounts[block]
        self._free.append(block)
        return True

    def attach_shared(self, uid: int, blocks: list[int]) -> None:
        """Map resident blocks (a matched cached prefix) into the FRONT of
        ``uid``'s table, one reference each; they leave through the normal
        ``free(uid)``."""
        for b in blocks:
            self.take_ref(b)
        self.tables.setdefault(uid, [])[:0] = list(blocks)

    def cow(self, uid: int, slot: int) -> Optional[tuple[int, int]]:
        """Copy-on-write: point ``uid``'s table ``slot`` at a fresh block and
        drop one reference on the shared original. Returns ``(old, new)``
        for the device copy (``PagedKVCache.copy_block``), or None if the
        pool is short."""
        old = self.tables[uid][slot]
        got = self._take_free(1)
        if got is None:
            return None
        self.tables[uid][slot] = got[0]
        self.refcounts[old] -= 1  # > 1 before the call, so never frees
        return old, got[0]

    def scramble_free(self, key: int) -> None:
        """Shuffle the free list deterministically (the chaos ``fragment``
        site, ``paged.py:243``): later allocations land on scattered ids.
        Accounting is untouched."""
        perm = np.random.default_rng(abs(key)).permutation(len(self._free))
        self._free = [self._free[i] for i in perm]

    def defragment(self) -> dict[int, int]:
        """Compact the singly-referenced live blocks onto the lowest ids
        (``paged.py:251``). A block with refcount > 1 (shared by tables
        and/or prefix-cache entries) stays PINNED where it is and the
        others pack around it. Tables, refcounts, the prefix cache's
        entries and the free list follow the move. Returns the {old: new}
        mapping (identity moves left out) for ``PagedKVCache.apply_mapping``."""
        pinned = {b for b, rc in self.refcounts.items() if rc > 1}
        movable = sorted(b for b, rc in self.refcounts.items() if rc == 1)
        targets, cand = [], 1
        while len(targets) < len(movable):
            if cand not in pinned:
                targets.append(cand)
            cand += 1
        mapping = {old: new for old, new in zip(movable, targets) if old != new}
        if mapping:
            for blocks in self.tables.values():
                blocks[:] = [mapping.get(b, b) for b in blocks]
            self.refcounts = {mapping.get(b, b): rc for b, rc in self.refcounts.items()}
            if self.prefix_cache is not None:
                self.prefix_cache.remap(mapping)
            self._free = [b for b in range(self.num_blocks - 1, 0, -1)
                          if b not in self.refcounts]
        return mapping


# ==========================================================================
# Content-hash prefix index
# ==========================================================================
@dataclasses.dataclass
class PrefixEntry:
    """One cached prompt (``paged.py:290``): ``blocks`` cover ``n_tokens``
    (the last may be partial, shared by copy-on-write); ``stat_points``
    maps block-aligned token counts to ``dense_snapshot`` host copies;
    ``logits`` the next-token row after the whole prompt (a full hit emits
    from it)."""

    blocks: list[int]
    n_tokens: int
    tail: list[int]             # prompt tokens past the last full block
    hashes: list[bytes]         # chained digest after each full block
    stat_points: dict
    logits: Optional[np.ndarray]
    last_used: int = 0
    pins: int = 0  # admissions in flight between probe and attach


class PrefixCache:
    """Content-hash index of cached prompt prefixes over the block pool
    (``paged.py:316``). Digest i is ``sha1(digest[i-1] || int32-LE tokens
    of block i)``, so it fingerprints tokens [0, (i+1) * block_size) and a
    match is one lookup per block boundary, longest first. The index keeps
    the first entry for a key. Each entry holds one allocator reference per
    block (``_cache_refs`` counts them), so an entry is reclaimable when no
    live table maps any of its blocks; eviction is LRU, soft-pinned entries
    last, and cascades down overlapping chains. Hits, misses and evictions
    count in ``registry`` (the engine's when telemetry is on, else a
    private one), with the blocks each hit maps in ``prefix_hit_blocks``."""

    def __init__(self, allocator: BlockAllocator, max_blocks: int = 0,
                 registry=None):
        self.allocator = allocator
        self.block_size = allocator.block_size
        self.max_blocks = max_blocks
        self._index: dict[bytes, tuple[PrefixEntry, int]] = {}
        self._entries: list[PrefixEntry] = []
        self._cache_refs: dict[int, int] = {}
        self._clock = 0
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._hits = r.counter("prefix_cache_hits_total",
                               help="admissions attached to a cached prefix")
        self._misses = r.counter("prefix_cache_misses_total",
                                 help="admissions that found no usable cached prefix")
        self._evictions = r.counter("prefix_cache_evictions_total",
                                    help="cached prefixes dropped (LRU cap or pool pressure)")
        self._hit_blocks = r.histogram("prefix_hit_blocks",
                                       help="shared blocks mapped per cache hit",
                                       buckets=TICK_BUCKETS)
        self.chaos = None  # set by the engine: a ChaosInjector ("hash_collision")
        allocator.prefix_cache = self

    @staticmethod
    def block_hashes(prompt, block_size: int) -> list[bytes]:
        """Chained digest after each FULL block of ``prompt``."""
        out, d = [], b""
        for i in range(len(prompt) // block_size):
            blk = np.asarray(prompt[i * block_size:(i + 1) * block_size],
                             np.int32).tobytes()
            d = hashlib.sha1(d + blk).digest()
            out.append(d)
        return out

    def match(self, prompt) -> Optional[tuple[PrefixEntry, int]]:
        """Longest cached prefix: ``(entry, k)`` with ``k`` matched full
        blocks, or None. The chaos ``hash_collision`` site perturbs the
        lookup digests, so the probe misses: lost reuse, never wrong
        blocks."""
        hashes = self.block_hashes(prompt, self.block_size)
        if self.chaos is not None and self.chaos.fire("hash_collision"):
            hashes = [hashlib.sha1(b"chaos" + d).digest() for d in hashes]
        for i in range(len(hashes) - 1, -1, -1):
            got = self._index.get(hashes[i])
            if got is not None and got[1] >= i + 1:
                return got[0], i + 1
        return None

    def is_full_hit(self, entry: PrefixEntry, prompt, k: int) -> bool:
        """``(entry, k)`` covers ``prompt`` exactly and carries logits."""
        bs = self.block_size
        return (k == len(prompt) // bs and entry.n_tokens == len(prompt)
                and entry.tail == list(prompt[k * bs:]) and entry.logits is not None)

    def note_hit(self, entry: PrefixEntry, n_blocks: int) -> None:
        self.touch(entry)
        self._hits.inc()
        self._hit_blocks.observe(n_blocks)

    def note_miss(self) -> None:
        self._misses.inc()

    def pin(self, entry: PrefixEntry) -> None:
        """Soft pin across an admission window: LRU-bumped and evicted only
        after every unpinned candidate (never refused outright, so
        admission cannot deadlock on its own pin)."""
        self.touch(entry)
        entry.pins += 1

    def unpin(self, entry: PrefixEntry) -> None:
        entry.pins = max(entry.pins - 1, 0)

    def touch(self, entry: PrefixEntry) -> None:
        self._clock += 1
        entry.last_used = self._clock

    def insert(self, prompt, blocks, stat_points=None,
               logits=None) -> Optional[PrefixEntry]:
        """Cache a finished prefill: register its boundary digests and take
        a reference on the blocks covering the prompt. None when nothing
        was cached (sub-block prompt, or every boundary already indexed)."""
        bs = self.block_size
        hashes = self.block_hashes(prompt, bs)
        if not hashes:
            return None
        nb = -(-len(prompt) // bs)
        blocks = list(blocks[:nb])
        if len(blocks) < nb:
            return None
        self._clock += 1
        entry = PrefixEntry(
            blocks=blocks, n_tokens=len(prompt),
            tail=list(prompt[len(hashes) * bs:]), hashes=hashes,
            stat_points=dict(stat_points or {}),
            logits=None if logits is None else np.asarray(logits),
            last_used=self._clock)
        registered = False
        for i, d in enumerate(hashes):
            if d not in self._index:
                self._index[d] = (entry, i + 1)
                registered = True
        if not registered:
            return None
        for b in blocks:
            self.allocator.take_ref(b)
            self._cache_refs[b] = self._cache_refs.get(b, 0) + 1
        self._entries.append(entry)
        while (self.max_blocks > 0 and self.block_count() > self.max_blocks
               and self.evict_one()):
            pass
        return entry

    def _reclaimable(self, entry: PrefixEntry) -> bool:
        """No live table maps any of the entry's blocks."""
        return all(self.allocator.refcount(b) == self._cache_refs.get(b, 0)
                   for b in entry.blocks)

    def evictable_blocks(self) -> int:
        """Distinct blocks a full reclaim-only sweep would free now."""
        freeable: set[int] = set()
        held: set[int] = set()
        for e in self._entries:
            (freeable if self._reclaimable(e) else held).update(e.blocks)
        return len(freeable - held)

    def evict_one(self, reclaim_only: bool = False) -> bool:
        """Drop the LRU entry (with ``reclaim_only``, among the entries no
        live table maps); pinned entries only when nothing else is left."""
        cands = [e for e in self._entries if not reclaim_only or self._reclaimable(e)]
        if not cands:
            return False
        unpinned = [e for e in cands if not e.pins]
        victim = min(unpinned or cands, key=lambda e: e.last_used)
        for d in victim.hashes:
            got = self._index.get(d)
            if got is not None and got[0] is victim:
                del self._index[d]
        self._entries.remove(victim)
        for b in victim.blocks:
            rc = self._cache_refs[b] - 1
            if rc:
                self._cache_refs[b] = rc
            else:
                del self._cache_refs[b]
            self.allocator.release_ref(b)
        self._evictions.inc()
        return True

    def remap(self, mapping: dict[int, int]) -> None:
        """Follow a defragmentation (``paged.py:537``): entries' block ids
        move with the pool; digests are content-addressed and stay."""
        for e in self._entries:
            e.blocks = [mapping.get(b, b) for b in e.blocks]
        self._cache_refs = {mapping.get(b, b): rc for b, rc in self._cache_refs.items()}

    def block_count(self) -> int:
        return sum(len(e.blocks) for e in self._entries)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "blocks": self.block_count(),
                "index_keys": len(self._index), "hits": int(self._hits.value),
                "misses": int(self._misses.value),
                "evictions": int(self._evictions.value)}


class PagedKVCache:
    """Device storage for one engine's decode state: pools for the
    sequence-shaped leaves (``paged=True``, when the model has any: an
    attention-free stack such as xLSTM has none and is stored lane-dense,
    ``paged`` False, as the reference's ``has_paged_leaves``) or lane-dense
    K/V (``paged=False``), lane-dense tensors for everything else (the
    landmark sums, the streaming stats, Hymba's mamba state, xLSTM's cell
    states, Whisper's cross K/V). ``storage`` maps a key of
    ``kv_cache.storage_layout`` -> a tensor whose first axis stacks the
    key's layers (``layer_ids[key]``, in layer order): every commit,
    reset, snapshot, restore, rebase and block move below takes each key
    alike. ``pool_names`` are the pooled leaves, ``seq_names`` the
    sequence-shaped ones either way."""

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, device):
        self.cfg, self.serve = cfg, serve
        self.block_size = serve.block_size
        self.max_lanes, self.max_seq = serve.max_lanes, serve.max_seq
        self.num_blocks = serve.resolved_num_blocks
        layout = storage_layout(cfg, serve.max_seq)
        self.paged = serve.paged and any(
            leaf.seq_axis is not None for leaf in layout.values())
        self.pool_names, self.dense_names, self.seq_names = [], [], []
        self.storage: dict[str, torch.Tensor] = {}
        self.layer_ids = {name: leaf.layers for name, leaf in layout.items()}
        for name, leaf in layout.items():
            layers, rest, j = len(leaf.layers), leaf.shape, leaf.seq_axis
            dt = leaf.dtype or torch.float32
            if j is not None:
                self.seq_names.append(name)
            if j is not None and self.paged:
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

    def dense_snapshot(self, lane: int) -> list:
        """Host copies (never views of the storage) of a lane's lane-dense
        leaves (``paged.py:930``): the carried landmark / streaming state of
        a lane parked mid-prefill, or a prefix-cache stat point. On CUDA
        the copy syncs the host with the card."""
        return [self.storage[name][:, lane].to("cpu", copy=True)
                for name in self.dense_names]

    def dense_restore(self, lane: int, snap: list) -> None:
        """Reinstall a ``dense_snapshot`` into ``lane`` (``paged.py:941``)."""
        for name, x in zip(self.dense_names, snap):
            self.storage[name][:, lane].copy_(x)

    def copy_block(self, src: int, dst: int) -> None:
        """Copy one pool block's rows in every pooled leaf, on the current
        stream (``paged.py:1015``): the device half of copy-on-write,
        queued before the decode step that first writes the copy."""
        for name in self.pool_names:
            pool = self.storage[name]
            pool[:, :, dst].copy_(pool[:, :, src])

    def apply_mapping(self, mapping: dict[int, int]) -> None:
        """Move pool blocks after ``BlockAllocator.defragment``
        (``paged.py:1029``): block ``new`` takes block ``old``'s rows for
        every {old: new}. The rows are gathered into a fresh tensor before
        any is written, so moves whose sources and destinations overlap
        (a chain a -> b -> c) read the old contents. Block 0 is never in a
        mapping and stays the zero block."""
        if not mapping or not self.pool_names:
            return
        dev = next(iter(self.storage.values())).device
        old = torch.as_tensor(list(mapping), dtype=torch.long, device=dev)
        new = torch.as_tensor(list(mapping.values()), dtype=torch.long, device=dev)
        for name in self.pool_names:
            pool = self.storage[name]
            pool.index_copy_(2, new, pool.index_select(2, old))

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
        at its position) and the lane-dense leaves the layer returned
        (``new_layers[i]`` keyed as the storage; a leaf no step writes,
        Whisper's cross K/V, is not returned)."""
        bs = self.block_size
        lanes = torch.nonzero(active).squeeze(1)
        pos = positions.long()[lanes]
        if self.pool_names:
            blocks = tables.long()[lanes, pos // bs]
            offs = pos % bs
        for name, ids in self.layer_ids.items():
            store = self.storage[name]
            seq = name in self.seq_names
            for j, i in enumerate(ids):
                new = new_layers[i].get(name)
                if new is None:
                    continue
                if not seq:
                    store[j].index_copy_(0, lanes, new[lanes].to(store.dtype))
                    continue
                vals = new[lanes, :, 0]                   # (A, Hkv, Dh)
                if name in self.pool_names:               # (Hkv, NB, bs, Dh)
                    store[j][:, blocks, offs] = vals.transpose(0, 1).to(store.dtype)
                else:                                     # (lanes, Hkv, S, Dh)
                    store[j][lanes, :, pos] = vals.to(store.dtype)

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

    def make_chunk_step(self, chunk_fn, chunk_pad: int):
        """A chunked-prefill step of ONE lane (``paged.py:822``):
        assemble the lane's committed view (pools: the table's first
        start / bs blocks gathered; lane-dense K/V: rows 0..start-1), run
        ``chunk_fn(cache, tokens, start, chunk_valid) -> (logits, cache)``
        (``serve/prefill.py:make_chunk_prefill_fn``), then commit in
        place: the chunk's ceil(chunk_valid / bs) valid blocks into the
        table's slots from start / bs on (a pad row of the last one is
        zero, as ``write_prefill`` leaves it; blocks past the valid ones
        are not written), or rows start..start+chunk_valid-1 of the lane's
        dense K/V; and the carried leaves into the lane's slots. Returns
        ``fn(table_row, tokens, lane, start, chunk_valid) -> logits (1,
        chunk_pad, V)`` with ``table_row`` the lane's host block table,
        ``tokens`` (1, chunk_pad) on the device and host ints; ``start``
        must be block-aligned."""
        bs = self.block_size
        if chunk_pad % bs:
            raise ValueError("chunk_pad must be a block_size multiple")
        cb = chunk_pad // bs

        def fn(table_row, tokens, lane: int, start: int, chunk_valid: int):
            if start % bs:
                raise ValueError(f"chunk start {start} is not block-aligned")
            dev = tokens.device
            row = np.asarray(table_row, np.int64)
            views = {}
            for name, t in self.storage.items():
                if name in self.pool_names:
                    ids = torch.as_tensor(row[None, :start // bs], device=dev)
                    views[name] = self._gather_leaf(t, ids)
                elif name in self.seq_names:
                    views[name] = t[:, lane:lane + 1, :, :start]
                else:
                    views[name] = t[:, lane:lane + 1]
            logits, new = chunk_fn({"layers": views}, tokens, start, chunk_valid)
            new = new["layers"]
            nvb = -(-chunk_valid // bs)
            first = start // bs
            for name, t in self.storage.items():
                leaf = new[name][:, 0]
                if name in self.pool_names:               # (L, Hkv, chunk_pad, Dh)
                    split = leaf.reshape(*leaf.shape[:2], cb, bs, leaf.shape[-1])
                    ids = torch.as_tensor(row[first:first + nvb], device=dev)
                    t.index_copy_(2, ids, split[:, :, :nvb].to(t.dtype))
                elif name in self.seq_names:
                    t[:, lane, :, start:start + chunk_valid] = (
                        leaf[:, :, :chunk_valid].to(t.dtype))
                else:
                    t[:, lane] = leaf.to(t.dtype)
            return logits

        return fn

    def make_rebase_step(self, rebase_fn):
        """Recompute lane-dense leaves of some lanes from their K/V
        (``paged.py:952``: the frozen boundary rebase, the stats reseed).
        As the reference's program, it runs over EVERY lane at a fixed
        batch (views ``n_view_blocks`` blocks long, gathered from the
        pools, or the lane-dense storage as it is) and commits only the
        given lanes: a lane's result then does not depend on which others
        rebase with it (a batch of another size may round differently).
        ``rebase_fn(layers, positions) -> layers`` takes per-layer
        lane-batched leaves (``decode_state.make_rebase_fn`` /
        ``make_reseed_fn``); K/V are read, never written. Returns
        ``fn(tables, positions, lanes, n_view_blocks)`` with host tables
        (max_lanes, blocks_per_lane), positions (max_lanes,) and a list of
        lanes."""

        def fn(tables, positions, lanes: list, n_view_blocks: int):
            dev = next(iter(self.storage.values())).device
            sel = torch.as_tensor(np.asarray(lanes, np.int64), device=dev)
            pos = torch.as_tensor(np.asarray(positions), device=dev)
            rows = torch.as_tensor(np.asarray(tables, np.int64)[:, :n_view_blocks],
                                   device=dev)
            views = {name: self._gather_leaf(t, rows) if name in self.pool_names else t
                     for name, t in self.storage.items()}
            layers = [layer_leaves(self.cfg, views, i)
                      for i in range(self.cfg.num_layers)]
            new_layers = rebase_fn(layers, pos)
            for name in STREAM_LEAVES:   # the only leaves a rebase rewrites
                store = self.storage[name]
                for j, i in enumerate(self.layer_ids[name]):
                    store[j].index_copy_(0, sel, new_layers[i][name][sel].to(store.dtype))

        return fn
