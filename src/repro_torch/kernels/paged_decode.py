"""Gather-free paged decode kernel K5: online-softmax row partials read
straight from the shared K/V block pools through per-lane block tables.

    paged_row_stats_lanes(q, k_pools, v_pool, table, kv_valid)
        -> fp32 (m, l, acc) of softmax(scale * q . K[0..kv_valid-1]) rows

mirrors ``repro/kernels/paged_decode.py:162``. Scores sum over the key
pools, q's features split across them in order: the dense family passes
one pool, absorbed MLA two (the 512-wide latent pool and the 64-wide rope
pool, the latent pool also the value pool). Lanes are the leading batch
axis, so one launch serves every lane of a decode tick; the reference's
single-lane entry point is ``paged_row_stats`` (K5 launched with one
lane); its ``custom_vmap`` rule has no counterpart, since the port's
decode tick launches K5 once for every lane.
Rows with no valid key return the absorbing anchor (m=-1e30, l=0, acc=0)
that ``kernels.ops.flash_merge`` re-anchors at the first merged score.
For CUDA tensors the wrapper launches ``csrc/paged_row_stats.cu`` on the
split-slot grid of ``slot_chunk_plan`` or raises; for CPU tensors it runs
the plain version.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.attention import NEG_INF
from repro_torch.kernels import check_head_dims
from repro_torch.kernels.build import DTYPE_CODES, check_operands, launch
from repro_torch.kernels.dispatch import current_tiling

_STEP_KEYS = 32    # keys of one kernel step, one per lane (csrc kStepKeys)
_ROWS_PER_CTA = 64  # query rows a CTA takes; more take more CTAs (csrc kMaxRows)
_MAX_POOLS = 2      # key pools the kernel takes (csrc paged_row_stats_launch)
# CTAs the slot-chunk plan aims at: two resident per SM of the H100's 132,
# two waves (a sweep of 264-1056 at a 16k horizon found 528 fastest).
SLOT_TARGET_CTAS = 528


@dataclasses.dataclass(frozen=True)
class SlotChunkPlan:
    """How K5 cuts each lane's n_slots table slots into ``chunks`` chunks of
    ``chunk_slots`` slots, one CTA per (chunk, kv head, lane). Chunk edges
    lie at whole blocks. The kernel walks a chunk in steps of at most
    32 keys (``steps``): ``step_slots`` = 32 // bs whole blocks when
    bs <= 32, else ceil(bs / 32) slices of each block.
    Each chunk leaves fp32 partials (m, l, acc), the anchor if it holds no
    valid key, merged in chunk order; with one chunk the CTA writes the
    output directly."""
    lanes: int
    hkv: int
    n_slots: int
    block_size: int
    step_slots: int
    chunk_slots: int
    chunks: int

    def slots(self, i: int) -> tuple[int, int]:
        """Table slots [start, end) of chunk i."""
        return i * self.chunk_slots, min((i + 1) * self.chunk_slots, self.n_slots)

    def steps(self, i: int, n_valid_slots: int = None) -> list:
        """The kernel's steps over chunk i, whose slots below
        ``n_valid_slots`` (default: all) hold valid keys:
        ``[(first slot, blocks, key0, keys)]``, each step ``blocks`` whole
        blocks from its first slot (bs <= 32: floor(32 / bs) of them, the
        chunk's last step fewer), or one 32-key slice of one block starting
        at key ``key0`` (bs > 32: slices of 32 keys, the block's last one
        bs mod 32 when that is not 0). A step never crosses the chunk's
        edge and holds at most 32 keys."""
        lo, hi = self.slots(i)
        hi = min(hi, self.n_slots if n_valid_slots is None else n_valid_slots)
        bs, out = self.block_size, []
        if bs > _STEP_KEYS:
            for s in range(lo, hi):
                out += [(s, 1, k0, min(_STEP_KEYS, bs - k0))
                        for k0 in range(0, bs, _STEP_KEYS)]
        else:
            for s in range(lo, hi, self.step_slots):
                nb = min(self.step_slots, hi - s)
                out.append((s, nb, 0, nb * bs))
        return out

    def workspace_floats(self, r: int, dv: int) -> int:
        """fp32 workspace of the partials: m, l and acc (r * (dv + 2) floats)
        per (lane, kv head, chunk); none with one chunk."""
        if self.chunks == 1:
            return 0
        return self.lanes * self.hkv * self.chunks * r * (dv + 2)


def slot_step(block_size: int) -> int:
    """Table slots of one kernel step: max(1, 32 // bs) whole blocks."""
    return max(1, _STEP_KEYS // block_size)


def slot_chunk_plan(lanes: int, hkv: int, n_slots: int, block_size: int,
                    chunk_slots: int = 0) -> SlotChunkPlan:
    """The slot-chunk plan of K5 for ``lanes`` lanes of ``hkv`` kv heads and
    a table of ``n_slots`` slots of ``block_size`` keys: enough chunks per
    (lane, kv head) for about SLOT_TARGET_CTAS CTAs, each a whole number of
    steps of whole blocks (``step_slots`` = max(1, 32 // bs) slots: 2 at
    bs 16, 1 at bs 24, 32 or 64). Sized from the table's width alone:
    kv_valid lives on the device, so the host never waits for it.
    ``chunk_slots`` > 0 overrides the chunk (whole steps: a positive
    multiple of ``slot_step``)."""
    step = slot_step(block_size)
    if chunk_slots:
        if chunk_slots < 0 or chunk_slots % step:
            raise ValueError(f"slot_chunk_plan: chunk_slots={chunk_slots} must be a "
                             f"positive multiple of {step} (whole steps at block "
                             f"size {block_size})")
    else:
        units = -(-n_slots // step)
        want = -(-SLOT_TARGET_CTAS // max(1, lanes * hkv))
        chunk_slots = step * max(1, -(-units // max(1, min(units, want))))
    return SlotChunkPlan(lanes=lanes, hkv=hkv, n_slots=n_slots, block_size=block_size,
                         step_slots=step, chunk_slots=chunk_slots,
                         chunks=max(1, -(-n_slots // chunk_slots)))


def paged_row_stats_plain(q, k_pools, v_pool, table, kv_valid, *,
                          scale: float, chunk_slots: int = 0):
    """Plain version of K5, mirroring ``repro/kernels/paged_decode.py:162``
    ``paged_row_stats_lanes`` (body ``_paged_row_stats_kernel`` :83): the
    lane's slots are gathered through ``table``, scores summed over the key
    pools (q's features split across them in order), keys at positions
    >= kv_valid[lane] masked with -1e30 and their weights zeroed.
    ``chunk_slots`` (the kernel's tiling) is ignored."""
    lanes, hkv, r, _ = q.shape
    n_slots = table.shape[1]
    tbl = table.long()

    def gather(pool):  # (hkv, nb, bs, e) -> (lanes, hkv, n_slots * bs, e)
        g = pool[:, tbl]
        return g.permute(1, 0, 2, 3, 4).reshape(lanes, hkv, -1, pool.shape[-1])

    qf = q.float()
    s, off = None, 0
    for pool in k_pools:
        dp = pool.shape[-1]
        part = torch.einsum("lhrd,lhsd->lhrs", qf[..., off:off + dp],
                            gather(pool).float())
        s = part if s is None else s + part
        off += dp
    s = s * scale
    n_keys = n_slots * v_pool.shape[2]
    mask = (torch.arange(n_keys, device=q.device)[None, :]
            < kv_valid.to(q.device).long()[:, None])[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("lhrs,lhsd->lhrd", p, gather(v_pool).float())
    return m, l, acc


def paged_row_stats_lanes(q: torch.Tensor, k_pools, v_pool: torch.Tensor,
                          table: torch.Tensor, kv_valid: torch.Tensor, *,
                          scale: float, block_size: int, chunk_slots: int = 0):
    """One call for all lanes. q (lanes, hkv, r, d); ``k_pools`` a tuple of
    key pools (hkv, num_blocks, bs, d_p) whose widths d_p sum to d (q's
    features split across them in order; a ``ValueError`` otherwise, as
    the reference raises); v_pool (hkv, num_blocks, bs, dv), which may be
    the first key pool itself (absorbed MLA); table (lanes, n_slots)
    int32; kv_valid (lanes,) int32. Returns fp32 (m, l, acc): (lanes, hkv,
    r, 1) x2 and (lanes, hkv, r, dv). On the card the kernel runs one CTA
    per (chunk of ``slot_chunk_plan``, kv head, row group, lane) and, with
    more than one chunk, a second launch merges the chunks' partials in
    order; ``chunk_slots`` > 0 sets the chunk (whole steps; 0 = the decode
    plan's in effect, ``dispatch.use_tiling``, else ``slot_chunk_plan``'s),
    which the plain version ignores."""
    k_pools = tuple(k_pools)
    lanes, hkv, r, d = q.shape
    hp, nb, bs, dv = v_pool.shape
    splits = tuple(int(p.shape[-1]) for p in k_pools)
    if sum(splits) != d:
        raise ValueError(f"key-pool feature dims {splits} must sum to q's last dim {d}")
    if (bs != block_size or hp != hkv
            or any(p.shape[:3] != v_pool.shape[:3] for p in k_pools)):
        raise ValueError("paged_row_stats_lanes: pool shapes disagree")
    if table.shape[0] != lanes or kv_valid.shape != (lanes,):
        raise ValueError("paged_row_stats_lanes: table/kv_valid need one row "
                         "per lane")
    if not q.is_cuda:
        return paged_row_stats_plain(q, k_pools, v_pool, table, kv_valid,
                                     scale=scale)
    return _paged_row_stats_cuda(q, k_pools, v_pool, table, kv_valid, scale=scale,
                                 chunk_slots=chunk_slots or current_tiling().chunk_slots)


def _paged_row_stats_cuda(q, k_pools, v_pool, table, kv_valid, *, scale,
                          chunk_slots=0):
    """Check the operands and launch csrc/paged_row_stats.cu (the
    arguments of ``paged_row_stats_plain``, at most two key pools) on the
    grid of ``slot_chunk_plan``, with the workspace of its partials
    allocated here (two launches when the plan has more than one chunk).
    When the value pool is the first key pool (the same storage), the
    kernel copies each block once for scores and values."""
    lanes, hkv, r, d = q.shape
    _, nb, bs, dv = v_pool.shape
    check_operands("paged_row_stats_lanes", {
        "q": q, **{f"k_pool{i}": p for i, p in enumerate(k_pools)}, "v_pool": v_pool,
        "table": table, "kv_valid": kv_valid})
    dev = q.device
    if not 0 < len(k_pools) <= _MAX_POOLS:
        raise ValueError(f"paged_row_stats_lanes: 1 to {_MAX_POOLS} key pools, "
                         f"got {len(k_pools)}")
    if str(q.dtype) not in DTYPE_CODES or any(
            t.dtype != q.dtype for t in (*k_pools, v_pool)):
        raise ValueError("paged_row_stats_lanes: q and the pools must share "
                         "an fp32 or bf16 dtype")
    if table.dtype != torch.int32 or kv_valid.dtype != torch.int32:
        raise ValueError("paged_row_stats_lanes: table and kv_valid must be "
                         "int32")
    check_head_dims("paged_row_stats", d, dv)
    plan = slot_chunk_plan(lanes, hkv, table.shape[1], bs, chunk_slots)
    es = q.element_size()
    widths = [p.shape[-1] for p in k_pools]
    # The kernel bulk-copies whole pool blocks (16-byte aligned, whole
    # 16-byte units) and reads rows in 4-element chunks.
    if (any(w % 4 or (bs * w * es) % 16 for w in (*widths, dv))
            or any(t.data_ptr() % 16 for t in (q, *k_pools, v_pool))):
        raise ValueError(f"paged_row_stats_lanes: q and pool blocks of {bs} x "
                         f"({widths}, {dv}) {q.dtype} must be 16-byte aligned, the "
                         f"blocks whole 16-byte units, widths multiples of 4")
    m = torch.empty((lanes, hkv, r, 1), dtype=torch.float32, device=dev)
    l = torch.empty((lanes, hkv, r, 1), dtype=torch.float32, device=dev)
    acc = torch.empty((lanes, hkv, r, dv), dtype=torch.float32, device=dev)
    if lanes and hkv and r:
        floats = plan.workspace_floats(r, dv)
        ws = torch.empty(floats, dtype=torch.float32, device=dev) if floats else None
        k1 = k_pools[1] if len(k_pools) > 1 else None
        launch("paged_row_stats", q.data_ptr(), k_pools[0].data_ptr(),
               k1.data_ptr() if k1 is not None else None, v_pool.data_ptr(),
               table.data_ptr(), kv_valid.data_ptr(), m.data_ptr(), l.data_ptr(),
               acc.data_ptr(), ws.data_ptr() if ws is not None else None, lanes, hkv,
               r, widths[0], widths[1] if k1 is not None else 0, dv, nb, bs,
               table.shape[1], plan.chunk_slots, float(scale),
               DTYPE_CODES[str(q.dtype)], torch.cuda.current_stream(dev).cuda_stream)
        paged_row_stats_lanes.launches += 1
    return m, l, acc


paged_row_stats_lanes.launches = 0


def paged_row_stats(q: torch.Tensor, k_pools, v_pool: torch.Tensor,
                    table: torch.Tensor, kv_valid, *, scale: float,
                    block_size: int, chunk_slots: int = 0):
    """Single-lane K5 (``repro/kernels/paged_decode.py:267``): q (hkv, r,
    d), table (n_slots,) int32, kv_valid a scalar. Adds the lane axis,
    launches ``paged_row_stats_lanes`` with one lane (its kernel on CUDA
    tensors, its plain version on CPU ones) and returns fp32 (m, l, acc) of
    shapes (hkv, r, 1), (hkv, r, 1), (hkv, r, dv)."""
    kv = torch.as_tensor(kv_valid, dtype=torch.int32, device=q.device).reshape(1)
    m, l, acc = paged_row_stats_lanes(
        q[None], k_pools, v_pool, table.to(torch.int32)[None], kv, scale=scale,
        block_size=block_size, chunk_slots=chunk_slots)
    return m[0], l[0], acc[0]
