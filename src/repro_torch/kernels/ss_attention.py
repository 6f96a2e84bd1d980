"""Spectral-shifting attention kernels K1 (B-side) and K2 (F-side).

* ``landmark_summary`` (K1): ``BV = softmax(scale * Q~ K^T) V`` for the c
  landmark rows, optionally with the fp32 online-softmax stats (m, l).
* ``query_side`` (K2): ``out = softmax(scale * Q K~^T) M + delta * V``.

Both take the segment-causal masks and the dynamic bounds of the
reference (``repro/kernels/ss_attention.py``), K1 its ``kv_offset`` (a
sequence shard's global key offset, ``kernels/sharded.py``) and K2 its
``q_offset``. For a CUDA tensor the
wrapper launches the hand-written kernel (``csrc/landmark_summary.cu``,
``csrc/query_side.cu``) or raises; for a CPU tensor it runs the plain
version beside it. The bf16 kernels tile by their own plans
(``chunk_plan``, ``query_tile_plan``) unless the caller passes a tiling
(``chunk_keys``, ``run_rows``: a dispatch plan's ``block_n``,
``kernels/dispatch.py``); one they cannot take raises ``ValueError``
before any launch. The fp32 kernels do not tile keys or query runs and
the plain versions ignore every tiling. The reference's ``block_c`` is K1
and K3's ``row_block``: the landmark rows a CTA of their bf16 kernels
walks, a whole number of ROW_TILEs (0 = one ROW_TILE a CTA, every row tile
on the grid). Every kernel takes any c: past 64 landmark columns K2 and K4
walk the landmark axis in tiles of 64 (``csrc/query_side_ct.cuh``), and K3
leaves fp32 partials of dK and dV per row tile, summed in order. The
reference's ``interpret`` has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.attention import NEG_INF
from repro_torch.kernels import check_head_dims
from repro_torch.kernels.build import DTYPE_CODES, check_operands, launch
from repro_torch.kernels.dispatch import current_tiling

# The bf16 tensor-core kernels of K1 and K3 (csrc/mma.cuh): landmark rows in
# tiles of 64 (wgmma's M; a CTA walks row_block / 64 of them), keys in tiles
# of 64, head dims multiples of 8 up to each kernel's limit
# (kernels.HEAD_DIM_LIMITS); K1 and K2 past 128 take d in 128-column tiles
# and dv in 128-column tiles on a grid axis (their wide-head variants, chosen
# inside the .cu by shape). K2 and K4 take the landmark columns in tiles of
# ROW_TILE too.
ROW_TILE = 64
KEY_TILE = 64
# CTAs the chunk plan and K2's query-tile plan aim at: two resident per SM
# of the H100's 132, two waves.
TARGET_CTAS = 528
# Query rows per step of the bf16 K2 kernel (csrc/query_side.cu kStepRows):
# one wgmma M.
QUERY_TILE = 64


def _stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------------
# The split-key grid of the bf16 kernels K1 and K3.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """How the tensor-core K1 and K3 cut the keys [0, n_end) that some row
    may attend into ``chunks`` chunks of ``chunk_keys`` keys (whole 64-key
    tiles), one CTA per (chunk, row tile, batch-head). Each chunk leaves
    fp32 partials for the rows that reach it, merged in chunk order. Keys
    are local to a shard whose key 0 sits at global position
    ``kv_offset`` (0 unsharded); the segment-causal reach is global."""
    b: int
    c: int
    n_end: int
    seg: int
    chunk_keys: int
    chunks: int
    kv_offset: int = 0

    def bounds(self, i: int) -> tuple[int, int]:
        """Keys [start, end) of chunk i."""
        return i * self.chunk_keys, min((i + 1) * self.chunk_keys, self.n_end)

    def reach(self, r: int) -> int:
        """Row r may attend keys [0, reach(r)) (none when <= 0: a low row on
        a later shard)."""
        if not self.seg:
            return self.n_end
        return min(self.n_end, (r + 1) * self.seg - self.kv_offset)

    def first_row(self, i: int) -> int:
        """The first row that can attend a key of chunk i (c if none)."""
        if not self.seg:
            return 0
        return min(self.c, (self.kv_offset + self.bounds(i)[0]) // self.seg)

    def row_chunks(self, r: int) -> int:
        """Chunks row r reaches: 0 .. row_chunks(r) - 1."""
        return max(0, -(-self.reach(r) // self.chunk_keys))

    def workspace_floats(self, per_row: int) -> int:
        """fp32 workspace of the partials, ``per_row`` floats per row and
        chunk (K1: m, l and acc, dv + 2; K3: dQ~, d); none when one chunk
        writes the output directly."""
        return self.b * self.chunks * self.c * per_row if self.chunks > 1 else 0


def check_multiple(name: str, what: str, value: int, quantum: int) -> None:
    """Raise ValueError unless ``value`` is a positive multiple of
    ``quantum`` (a tiling a kernel takes)."""
    if value <= 0 or value % quantum:
        raise ValueError(f"{name}: {what}={value} must be a positive multiple of "
                         f"{quantum}")


def chunk_plan(b: int, c: int, n: int, *, seg: int = 0,
               kv_end: Optional[int] = None, chunk_keys: int = 0,
               kv_offset: int = 0, row_block: int = ROW_TILE) -> ChunkPlan:
    """The chunk plan of K1 / K3 for b batch-heads, c rows and n keys under
    ``seg`` (segment-causal, 0 = none) and ``kv_end`` (global, like the
    segment-causal bound; the keys' first global position is
    ``kv_offset``): n_end = the keys any row may attend
    (``common.cuh:b_side_end``); enough chunks per (head, row group of
    ``row_block`` rows) to give about TARGET_CTAS CTAs, at most one per
    64-key tile. ``chunk_keys`` > 0 overrides the chunk size (a whole number
    of KEY_TILE keys)."""
    n_end = n if kv_end is None else min(int(kv_end) - kv_offset, n)
    if seg:
        n_end = min(n_end, c * seg - kv_offset)
    n_end = max(n_end, 0)
    if chunk_keys:
        check_multiple("chunk_plan", "chunk_keys", chunk_keys, KEY_TILE)
    else:
        tiles = -(-n_end // KEY_TILE)
        want = -(-TARGET_CTAS // max(1, b * -(-c // row_block)))
        chunk_keys = max(1, -(-tiles // max(1, min(tiles, want)))) * KEY_TILE
    return ChunkPlan(b=b, c=c, n_end=n_end, seg=seg, chunk_keys=chunk_keys,
                     chunks=-(-n_end // chunk_keys), kv_offset=kv_offset)


# --------------------------------------------------------------------------
# The query-tile runs of the bf16 kernels K2 and K4.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QueryTilePlan:
    """How K2 and K4 cut the n query rows of each of b batch-heads into
    ``runs`` runs of ``run_rows`` rows (whole steps of ``step_rows``), one
    CTA per (run, batch-head). K4 leaves one fp32 partial of dK~, dM and
    ddelta per run, summed over the runs in order."""
    b: int
    n: int
    step_rows: int
    run_rows: int
    runs: int

    def rows(self, i: int) -> tuple[int, int]:
        """Query rows [start, end) of run i."""
        return i * self.run_rows, min((i + 1) * self.run_rows, self.n)

    def workspace_floats(self, c: int, d: int, dv: int) -> int:
        """K4's fp32 workspace: dK~ (c x d), dM (c x dv) and ddelta per run."""
        return self.b * self.runs * (c * (d + dv) + 1)


def query_tile_plan(b: int, n: int, *, step_rows: int = QUERY_TILE,
                    target_ctas: Optional[int] = None,
                    run_rows: int = 0) -> QueryTilePlan:
    """The query-tile plan for b batch-heads of n query rows: enough runs per
    head for about ``target_ctas`` CTAs (default TARGET_CTAS), at most one
    per step of ``step_rows`` rows. ``run_rows`` > 0 overrides the run
    length (a whole number of steps)."""
    if run_rows:
        check_multiple("query_tile_plan", "run_rows", run_rows, step_rows)
    else:
        target = TARGET_CTAS if target_ctas is None else target_ctas
        steps = -(-n // step_rows)
        want = -(-target // max(1, b))
        run_rows = max(1, -(-steps // max(1, min(steps, want)))) * step_rows
    return QueryTilePlan(b=b, n=n, step_rows=step_rows, run_rows=run_rows,
                         runs=-(-n // run_rows))


def tensor_core_pair(q_l: torch.Tensor, k: torch.Tensor) -> bool:
    """K1 and K3 run their tensor-core kernels for bf16 queries and keys
    and their fp32 kernels for fp32 queries (a dispatch by dtype)."""
    return q_l.dtype == k.dtype == torch.bfloat16


def row_block_for(name: str, row_block: int) -> int:
    """The rows a CTA of K1 / K3's bf16 kernel walks: ``row_block`` (the
    reference's ``block_c``, a positive multiple of ROW_TILE) or, for 0,
    one ROW_TILE. Raises ValueError for any other value."""
    if not row_block:
        return ROW_TILE
    check_multiple(name, "row_block", row_block, ROW_TILE)
    return row_block


def check_tensor_core_shapes(name: str, tensors: dict, dims: dict) -> None:
    """Raise unless the tensor-core kernels take these operands: head dims
    positive multiples of 8 (the limits are ``check_head_dims``'s) and
    16-byte-aligned data (cp.async)."""
    for dim, val in dims.items():
        if val % 8 or val <= 0:
            raise ValueError(f"{name}: bf16 {dim}={val} must be a positive "
                             f"multiple of 8")
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


# --------------------------------------------------------------------------
# K1: landmark summary.
# --------------------------------------------------------------------------
def b_side_mask(c: int, n: int, *, seg: int = 0, kv_offset: int = 0,
                kv_end: Optional[int] = None, device=None) -> torch.Tensor:
    """(c, n) validity of key j for landmark row r (``_b_side_mask`` :62):
    global position ``kv_offset + j`` below ``kv_end`` (default
    ``kv_offset + n``) and, with ``seg``, below (r + 1) * seg. Shared by K1
    and K3's plain versions so the two cannot drift apart."""
    end = kv_offset + n if kv_end is None else kv_end
    kv_pos = kv_offset + torch.arange(n, device=device)
    mask = (kv_pos < end)[None, :].expand(c, n)
    if seg:
        row = torch.arange(c, device=device)[:, None]
        mask = mask & (kv_pos[None, :] < (row + 1) * seg)
    return mask


def landmark_summary_plain(q_l, k, v, *, scale: float, seg: int = 0,
                           kv_offset: int = 0, kv_end: Optional[int] = None,
                           return_stats: bool = False, chunk_keys: int = 0,
                           row_block: int = 0):
    """Plain version of K1, mirroring ``repro/kernels/ss_attention.py:195``
    ``landmark_summary`` (masks of ``_b_side_mask`` :62): key j has global
    position ``kv_offset + j`` and is valid iff it is < ``kv_end`` (default
    ``kv_offset + n``) and, with ``seg``, < (row + 1) * seg. One softmax
    over all keys instead of the kernel's stream; same masks, same -1e30
    anchor and 1e-30 floor. Returns ``out`` in v's dtype, plus fp32 (m, l)
    of shape (b, c, 1) with ``return_stats``. ``chunk_keys`` and
    ``row_block`` (the kernel's tiling) are taken and ignored, so this
    version stands in for ``_landmark_summary_cuda`` with the same
    arguments."""
    mask = b_side_mask(q_l.shape[1], k.shape[1], seg=seg, kv_offset=kv_offset,
                       kv_end=kv_end, device=k.device)
    s = torch.einsum("bcd,bnd->bcn", q_l.float(), k.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bcn,bnd->bcd", p, v.float())
    out = (acc / torch.clamp(l, min=1e-30)).to(v.dtype)
    return (out, m, l) if return_stats else out


def landmark_summary(q_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float, causal: bool = False,
                     return_stats: bool = False, kv_valid=None,
                     seq_len_k: int = 0, kv_offset: int = 0, chunk_keys: int = 0,
                     row_block: int = 0):
    """BV = softmax(Q~ K^T * scale) @ V. q_l (b, c, d), k (b, n, d),
    v (b, n, dv) -> (b, c, dv) in v's dtype [+ fp32 m, l (b, c, 1)].

    Key j sits at global position ``kv_offset + j`` (a sequence shard's
    offset under ``kernels/sharded.py``; 0 otherwise). ``causal`` applies
    the segment-causal B-mask on global positions with seg =
    ceil(seq_len_k / c) (seq_len_k defaults to n). ``kv_valid`` (host int,
    global) masks key j unless kv_offset + j < kv_valid (bucketed prefill
    passes the prompt length; the sharded attention the true sequence end); it
    is clamped to kv_offset + n. A row that reaches no key returns
    (out 0, m -1e30, l 0). ``chunk_keys`` > 0 sets the bf16 kernel's key
    chunk (whole KEY_TILEs; 0 = ``chunk_plan``'s), ``row_block`` > 0 the
    landmark rows a CTA walks (whole ROW_TILEs; 0 = one ROW_TILE)."""
    b, c, d = q_l.shape
    n, dv = k.shape[1], v.shape[2]
    if k.shape != (b, n, d) or v.shape[:2] != (b, n):
        raise ValueError(f"landmark_summary: shapes q_l {tuple(q_l.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    seg = -(-(seq_len_k or n) // c) if causal else 0
    off = int(kv_offset)
    end = off + n if kv_valid is None else min(int(kv_valid), off + n)
    if not q_l.is_cuda:
        return landmark_summary_plain(q_l, k, v, scale=scale, seg=seg, kv_offset=off,
                                      kv_end=end, return_stats=return_stats)
    return _landmark_summary_cuda(q_l, k, v, scale=scale, seg=seg, kv_offset=off,
                                  kv_end=end, return_stats=return_stats,
                                  chunk_keys=chunk_keys or current_tiling().block_n,
                                  row_block=row_block)


def _landmark_summary_cuda(q_l, k, v, *, scale, seg, kv_end, return_stats,
                           kv_offset=0, chunk_keys=0, row_block=0):
    """Check the operands and launch csrc/landmark_summary.cu (same
    arguments as ``landmark_summary_plain``): the tensor-core kernel for
    bf16 q_l, k, v, with the workspace of its chunk plan allocated here,
    else the fp32 kernel."""
    b, c, d = q_l.shape
    n, dv = k.shape[1], v.shape[2]
    check_operands("landmark_summary", {"q_l": q_l, "k": k, "v": v}, DTYPE_CODES)
    if k.dtype != v.dtype:
        raise ValueError("landmark_summary: k and v must share a dtype")
    if q_l.dtype == torch.bfloat16 and k.dtype == torch.float32:
        raise ValueError("landmark_summary: bf16 queries against fp32 keys "
                         "are not built")
    check_head_dims("landmark_summary", d, dv)
    if chunk_keys:
        check_multiple("landmark_summary", "chunk_keys", chunk_keys, KEY_TILE)
    row_block = row_block_for("landmark_summary", row_block)
    out = torch.empty((b, c, dv), dtype=v.dtype, device=v.device)
    m = l = None
    if return_stats:
        # two tensors, not views of one: K1's custom op returns both, and an
        # op's outputs may not alias each other
        m = torch.empty((b, c, 1), dtype=torch.float32, device=v.device)
        l = torch.empty_like(m)
    ws, tile = None, 0
    if tensor_core_pair(q_l, k):
        check_tensor_core_shapes("landmark_summary", {"q_l": q_l, "k": k, "v": v},
                                 {"d": d, "dv": dv})
        plan = chunk_plan(b, c, n, seg=seg, kv_end=kv_end, chunk_keys=chunk_keys,
                          kv_offset=kv_offset, row_block=row_block)
        tile = plan.chunk_keys
        if plan.chunks > 1:
            ws = torch.empty(plan.workspace_floats(dv + 2), dtype=torch.float32,
                             device=v.device)
    if b and c:
        launch("landmark_summary", q_l.data_ptr(), k.data_ptr(), v.data_ptr(),
               out.data_ptr(), m.data_ptr() if m is not None else None,
               l.data_ptr() if l is not None else None,
               ws.data_ptr() if ws is not None else None, b, c, n, d, dv,
               float(scale), kv_end, seg, kv_offset, tile, row_block,
               DTYPE_CODES[str(q_l.dtype)], DTYPE_CODES[str(k.dtype)], _stream_handle(v))
        landmark_summary.launches += 1
    return (out, m, l) if return_stats else out


landmark_summary.launches = 0


# --------------------------------------------------------------------------
# K2: query side.
# --------------------------------------------------------------------------
def query_side_probs(q, k_l, *, scale: float, seg: int = 0,
                     pos_offset: int = 0) -> torch.Tensor:
    """fp32 P (b, n, c) of K2 (``_query_side_probs`` :311): the row softmax
    over the c landmark columns, with the segment-causal F-mask
    ``col <= (pos_offset + i) // seg`` when ``seg`` is set. Shared by K2
    and K4's plain versions."""
    n, c = q.shape[1], k_l.shape[1]
    s = torch.einsum("bnd,bcd->bnc", q.float(), k_l.float()) * scale
    mask = None
    if seg:
        qpos = pos_offset + torch.arange(n, device=q.device)
        mask = torch.arange(c, device=q.device)[None, :] <= (qpos // seg)[:, None]
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def query_side_plain(q, k_l, m_mat, v, delta, *, scale: float, seg: int = 0,
                     pos_offset: int = 0, run_rows: int = 0):
    """Plain version of K2, mirroring ``repro/kernels/ss_attention.py:365``
    ``query_side``: ``query_side_probs`` then ``P @ M + delta * V`` in fp32,
    output in q's dtype (``run_rows``, the kernel's tiling, ignored)."""
    p = query_side_probs(q, k_l, scale=scale, seg=seg, pos_offset=pos_offset)
    out = torch.einsum("bnc,bcd->bnd", p, m_mat.float())
    out = out + delta.float() * v.float()
    return out.to(q.dtype)


def query_side(q: torch.Tensor, k_l: torch.Tensor, m_mat: torch.Tensor,
               v: torch.Tensor, delta: torch.Tensor, *, scale: float,
               causal: bool = False, seq_len_k: int = 0, q_offset=None,
               run_rows: int = 0):
    """out = softmax(Q K~^T * scale) @ M + delta * V. q (b, n, d),
    k_l (b, c, d), m_mat (b, c, dv), v (b, n, dv), delta (b, 1, 1) fp32 ->
    (b, n, dv) in q's dtype. ``causal`` applies the segment-causal F-mask
    with seg = ceil(seq_len_k / c) and the queries at the tail of the
    seq_len_k context, or at ``q_offset`` when given. ``run_rows`` > 0 sets
    the bf16 kernel's query run (whole QUERY_TILEs; 0 = the serving tiling
    in effect, ``dispatch.use_tiling``, else ``query_tile_plan``'s)."""
    b, n, d = q.shape
    c, dv = k_l.shape[1], v.shape[2]
    if (k_l.shape != (b, c, d) or m_mat.shape != (b, c, dv)
            or v.shape != (b, n, dv) or delta.numel() != b):
        raise ValueError("query_side: operand shapes disagree")
    n_k = seq_len_k or n
    seg = -(-n_k // c) if causal else 0
    pos_offset = (n_k - n if q_offset is None else int(q_offset)) if causal else 0
    if not q.is_cuda:
        return query_side_plain(q, k_l, m_mat, v, delta, scale=scale, seg=seg,
                                pos_offset=pos_offset)
    return _query_side_cuda(q, k_l, m_mat, v, delta, scale=scale, seg=seg,
                            pos_offset=pos_offset,
                            run_rows=run_rows or current_tiling().block_n)


def _query_side_cuda(q, k_l, m_mat, v, delta, *, scale, seg, pos_offset,
                     run_rows=0):
    """Check the operands and launch csrc/query_side.cu (same arguments as
    ``query_side_plain``): the tensor-core kernel for bf16 operands, on the
    runs of its query-tile plan, else the fp32 kernel."""
    b, n, d = q.shape
    c, dv = k_l.shape[1], v.shape[2]
    check_operands("query_side", {"q": q, "k_l": k_l, "m_mat": m_mat, "v": v,
                               "delta": delta})
    if str(q.dtype) not in DTYPE_CODES or any(
            t.dtype != q.dtype for t in (k_l, m_mat, v)):
        raise ValueError("query_side: q, k_l, m_mat and v must share an "
                         "fp32 or bf16 dtype")
    if delta.dtype != torch.float32:
        raise ValueError("query_side: delta must be fp32")
    check_head_dims("query_side", d, dv)
    if run_rows:
        check_multiple("query_side", "run_rows", run_rows, QUERY_TILE)
    tile = 0
    if q.dtype == torch.bfloat16:
        check_tensor_core_shapes("query_side", {"q": q, "k_l": k_l, "m_mat": m_mat,
                                                "v": v}, {"d": d, "dv": dv})
        tile = query_tile_plan(b, n, run_rows=run_rows).run_rows
    out = torch.empty((b, n, dv), dtype=q.dtype, device=q.device)
    if b and n:
        launch("query_side", q.data_ptr(), k_l.data_ptr(), m_mat.data_ptr(),
               v.data_ptr(), delta.data_ptr(), out.data_ptr(), b, n, c, d, dv,
               float(scale), seg, pos_offset, tile, DTYPE_CODES[str(q.dtype)],
               _stream_handle(q))
        query_side.launches += 1
    return out


query_side.launches = 0
