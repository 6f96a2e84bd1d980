"""Backward kernels K3 (B-side) and K4 (F-side) of spectral-shift attention.

* ``landmark_summary_bwd`` (K3): given K1's saved fp32 stats (m, l) and its
  output BV, rebuilds P = exp(scale * Q~ K^T - m) / l exactly and returns
  dQ~ = (P o (g V^T - D)) K scale, dK = (P o (g V^T - D))^T Q~ scale and
  dV = P^T g, with D = rowsum(g o BV) computed here in torch.
* ``query_side_bwd`` (K4): recomputes K2's P per query row and returns
  dQ = dS K~, dK~ = dS^T Q, dM = P^T g, dV = delta g, ddelta = sum g o V.

Both mirror ``repro/kernels/ss_attention_bwd.py`` with the masks and
dynamic bounds of their forwards. For a CUDA tensor the wrapper launches
the hand-written kernel (``csrc/landmark_summary_bwd.cu``,
``csrc/query_side_bwd.cu``) or raises; for a CPU tensor it runs the plain
version beside it. The autograd Functions in ``kernels/ops.py`` call them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import NEG_INF
from repro_torch.kernels import check_head_dims
from repro_torch.kernels.build import DTYPE_CODES, check_operands, launch
from repro_torch.kernels.ss_attention import (KEY_TILE, ROW_TILE, _stream_handle,
                                              b_side_mask, check_multiple,
                                              check_tensor_core_shapes, chunk_plan,
                                              query_side_probs, query_tile_plan,
                                              row_block_for, tensor_core_pair)

# Query rows per step of csrc/query_side_bwd.cu's bf16 kernel (kStepRows):
# 64 for each of its two warpgroups. K4 writes one fp32 partial of dK~, dM
# and ddelta per run of steps, and its second kernel sums them in order.
QS_BWD_STEP_ROWS = 128
# CTAs K4's query-tile plan aims at: one wave of one CTA per SM (230 KB of
# shared memory each) on the H100's 132. A sweep of 1-32 runs per head at
# the training shape found one wave fastest (PERF.md): 2 runs of 2048
# rows per head, 112 CTAs, 7.3 MB of partials.
QS_BWD_TARGET_CTAS = 132


def query_side_bwd_plan(b: int, n: int, run_rows: int = 0):
    """K4's query-tile plan, for both dtypes (the fp32 kernel walks the same
    runs): the most runs per head that keep b x runs within
    QS_BWD_TARGET_CTAS, at least one; ``run_rows`` > 0 overrides the run
    length (whole QS_BWD_STEP_ROWS)."""
    return query_tile_plan(b, n, step_rows=QS_BWD_STEP_ROWS,
                           target_ctas=max(1, QS_BWD_TARGET_CTAS // max(1, b)) * b,
                           run_rows=run_rows)


# --------------------------------------------------------------------------
# K3: landmark summary backward.
# --------------------------------------------------------------------------
def landmark_summary_bwd_plain(q_l, k, v, g, m, l, dcoef, *, scale: float,
                               seg: int = 0, kv_offset: int = 0,
                               kv_end: Optional[int] = None, chunk_keys: int = 0,
                               row_block: int = 0):
    """Plain version of K3, mirroring ``ss_attention_bwd.py:49``
    ``_landmark_summary_bwd_kernel`` over all keys at once: the masks of
    ``b_side_mask``, p = exp(s - m) / max(l, 1e-30) zeroed where masked (a
    row with no valid key has l = 0 and keeps p = 0). ``dcoef`` is
    D = rowsum(g o BV), fp32 (b, c, 1). Returns (dq_l, dk, dv) in q_l's,
    k's and v's dtypes (``chunk_keys`` and ``row_block``, the kernel's
    tiling, ignored)."""
    mask = b_side_mask(q_l.shape[1], k.shape[1], seg=seg, kv_offset=kv_offset,
                       kv_end=kv_end, device=k.device)
    qf, kf, vf, gf = q_l.float(), k.float(), v.float(), g.float()
    s = torch.where(mask, torch.einsum("bcd,bnd->bcn", qf, kf) * scale, NEG_INF)
    p = torch.exp(s - m) / torch.clamp(l, min=1e-30)
    p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bce,bne->bcn", gf, vf)
    ds = p * (dp - dcoef) * scale
    dv = torch.einsum("bcn,bce->bne", p, gf)
    dk = torch.einsum("bcn,bcd->bnd", ds, qf)
    dq = torch.einsum("bcn,bnd->bcd", ds, kf)
    return dq.to(q_l.dtype), dk.to(k.dtype), dv.to(v.dtype)


def landmark_summary_bwd(q_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bv: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         g: torch.Tensor, *, scale: float, causal: bool = False,
                         kv_valid=None, seq_len_k: int = 0, kv_offset: int = 0,
                         chunk_keys: int = 0, row_block: int = 0):
    """Backward of ``landmark_summary``: (dq_l, dk, dv) from K1's inputs, its
    output ``bv`` and fp32 stats ``m``, ``l`` (b, c, 1), and the cotangent
    ``g`` of bv (made contiguous here: autograd may hand it expanded). Same
    ``causal`` / ``kv_valid`` / ``seq_len_k`` / ``kv_offset`` as the forward
    call. Under a sequence shard (``kernels/sharded.py``) ``bv``, ``m`` and
    ``l`` are the merged global ones and ``g`` the summed cotangent: dK, dV
    are then the shard's own rows and dq_l the shard's partial. Keys no row
    reaches get zeros. ``chunk_keys`` > 0 sets the bf16 kernel's key chunk
    (whole KEY_TILEs), ``row_block`` > 0 the landmark rows a CTA walks
    (whole ROW_TILEs; 0 = one)."""
    b, c, d = q_l.shape
    n, dv = k.shape[1], v.shape[2]
    if (k.shape != (b, n, d) or v.shape[:2] != (b, n)
            or bv.shape != (b, c, dv) or g.shape != (b, c, dv)
            or m.shape != (b, c, 1) or l.shape != (b, c, 1)):
        raise ValueError("landmark_summary_bwd: operand shapes disagree")
    seg = -(-(seq_len_k or n) // c) if causal else 0
    off = int(kv_offset)
    end = off + n if kv_valid is None else min(int(kv_valid), off + n)
    g = g.contiguous()
    # D_r = sum_j P_rj (g_r . v_j) = g_r . BV_r: O(c dv), stays in torch.
    dcoef = torch.sum(g.float() * bv.float(), dim=-1, keepdim=True)
    if not q_l.is_cuda:
        return landmark_summary_bwd_plain(q_l, k, v, g, m, l, dcoef, scale=scale,
                                          seg=seg, kv_offset=off, kv_end=end)
    return _landmark_summary_bwd_cuda(q_l, k, v, g, m, l, dcoef, scale=scale,
                                      seg=seg, kv_offset=off, kv_end=end,
                                      chunk_keys=chunk_keys, row_block=row_block)


def _landmark_summary_bwd_cuda(q_l, k, v, g, m, l, dcoef, *, scale, seg, kv_end,
                               kv_offset=0, chunk_keys=0, row_block=0):
    """Check the operands and launch csrc/landmark_summary_bwd.cu (same
    arguments as ``landmark_summary_bwd_plain``): the tensor-core pass for
    bf16 q_l, k, v, g, with the workspaces allocated here (dQ~'s partials
    per key chunk when its chunk plan has more than one; past one ROW_TILE,
    dK's and dV's partials per row tile), else the fp32 passes."""
    b, c, d = q_l.shape
    n, dv = k.shape[1], v.shape[2]
    check_operands("landmark_summary_bwd", {"q_l": q_l, "k": k, "v": v, "g": g,
                                            "m": m, "l": l, "dcoef": dcoef})
    if str(q_l.dtype) not in DTYPE_CODES or str(k.dtype) not in DTYPE_CODES:
        raise ValueError("landmark_summary_bwd: q_l and k must be fp32 or bf16")
    if not (k.dtype == v.dtype == g.dtype):
        raise ValueError("landmark_summary_bwd: k, v and g must share a dtype")
    if not (m.dtype == l.dtype == dcoef.dtype == torch.float32):
        raise ValueError("landmark_summary_bwd: m, l and dcoef must be fp32")
    if q_l.dtype == torch.bfloat16 and k.dtype == torch.float32:
        raise ValueError("landmark_summary_bwd: bf16 queries against fp32 keys "
                         "are not built")
    check_head_dims("landmark_summary_bwd", d, dv)
    if chunk_keys:
        check_multiple("landmark_summary_bwd", "chunk_keys", chunk_keys, KEY_TILE)
    row_block = row_block_for("landmark_summary_bwd", row_block)
    dq = torch.empty_like(q_l)
    dk = torch.empty_like(k)
    dv_out = torch.empty_like(v)
    ws = ws_kv = None
    tile = 0
    if tensor_core_pair(q_l, k):
        check_tensor_core_shapes("landmark_summary_bwd",
                                 {"q_l": q_l, "k": k, "v": v, "g": g},
                                 {"d": d, "dv": dv})
        plan = chunk_plan(b, c, n, seg=seg, kv_end=kv_end, chunk_keys=chunk_keys,
                          kv_offset=kv_offset, row_block=row_block)
        tile = plan.chunk_keys
        if plan.chunks > 1:
            ws = torch.empty(plan.workspace_floats(d), dtype=torch.float32,
                             device=k.device)
        if c > ROW_TILE:
            ws_kv = torch.empty(b * -(-c // ROW_TILE) * n * (d + dv),
                                dtype=torch.float32, device=k.device)
    if b and c and n:
        launch("landmark_summary_bwd", q_l.data_ptr(), k.data_ptr(), v.data_ptr(),
               g.data_ptr(), m.data_ptr(), l.data_ptr(), dcoef.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv_out.data_ptr(),
               ws.data_ptr() if ws is not None else None,
               ws_kv.data_ptr() if ws_kv is not None else None, b, c, n, d, dv,
               float(scale), kv_end, seg, kv_offset, tile, row_block,
               DTYPE_CODES[str(q_l.dtype)], DTYPE_CODES[str(k.dtype)], _stream_handle(k))
        landmark_summary_bwd.launches += 1
    return dq, dk, dv_out


landmark_summary_bwd.launches = 0


# --------------------------------------------------------------------------
# K4: query side backward.
# --------------------------------------------------------------------------
def query_side_bwd_plain(q, k_l, m_mat, v, delta, g, *, scale: float,
                         seg: int = 0, pos_offset: int = 0, run_rows: int = 0):
    """Plain version of K4, mirroring ``ss_attention_bwd.py:206``
    ``_query_side_bwd_kernel`` over all rows at once, with K2's
    ``query_side_probs`` (``run_rows``, the kernel's tiling, ignored).
    Returns (dq, dk_l, dm, dv, ddelta): dq, dv in q's / v's dtype, dk_l, dm
    in k_l's / m_mat's, ddelta fp32 (b, 1, 1)."""
    p = query_side_probs(q, k_l, scale=scale, seg=seg, pos_offset=pos_offset)
    qf, gf = q.float(), g.float()
    dp = torch.einsum("bne,bce->bnc", gf, m_mat.float())
    ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True)) * scale
    dq = torch.einsum("bnc,bcd->bnd", ds, k_l.float())
    dv = delta.float() * gf
    dkl = torch.einsum("bnc,bnd->bcd", ds, qf)
    dm = torch.einsum("bnc,bne->bce", p, gf)
    dd = torch.sum(gf * v.float(), dim=(1, 2), keepdim=True)
    return (dq.to(q.dtype), dkl.to(k_l.dtype), dm.to(m_mat.dtype),
            dv.to(v.dtype), dd)


def query_side_bwd(q: torch.Tensor, k_l: torch.Tensor, m_mat: torch.Tensor,
                   v: torch.Tensor, delta: torch.Tensor, g: torch.Tensor, *,
                   scale: float, causal: bool = False, seq_len_k: int = 0,
                   q_offset=None, run_rows: int = 0):
    """Backward of ``query_side``: (dq, dk_l, dm, dv, ddelta) from K2's
    inputs and the cotangent ``g`` of its output (made contiguous here).
    Same ``causal`` / ``seq_len_k`` / ``q_offset`` as the forward call;
    ``run_rows`` > 0 sets the query run (whole QS_BWD_STEP_ROWS; 0 =
    ``query_side_bwd_plan``'s)."""
    b, n, d = q.shape
    c, dv = k_l.shape[1], v.shape[2]
    if (k_l.shape != (b, c, d) or m_mat.shape != (b, c, dv)
            or v.shape != (b, n, dv) or g.shape != (b, n, dv)
            or delta.numel() != b):
        raise ValueError("query_side_bwd: operand shapes disagree")
    n_k = seq_len_k or n
    seg = -(-n_k // c) if causal else 0
    pos_offset = (n_k - n if q_offset is None else int(q_offset)) if causal else 0
    g = g.contiguous()
    if not q.is_cuda:
        return query_side_bwd_plain(q, k_l, m_mat, v, delta, g, scale=scale,
                                    seg=seg, pos_offset=pos_offset)
    return _query_side_bwd_cuda(q, k_l, m_mat, v, delta, g, scale=scale,
                                seg=seg, pos_offset=pos_offset, run_rows=run_rows)


def _query_side_bwd_cuda(q, k_l, m_mat, v, delta, g, *, scale, seg, pos_offset,
                         run_rows=0):
    """Check the operands and launch csrc/query_side_bwd.cu (same arguments
    as ``query_side_bwd_plain``): the tensor-core kernel for bf16 operands,
    else the fp32 kernel, on the runs of ``query_side_bwd_plan`` with the
    fp32 workspace of their partials allocated here."""
    b, n, d = q.shape
    c, dv = k_l.shape[1], v.shape[2]
    check_operands("query_side_bwd", {"q": q, "k_l": k_l, "m_mat": m_mat,
                                      "v": v, "delta": delta, "g": g})
    if str(q.dtype) not in DTYPE_CODES or any(
            t.dtype != q.dtype for t in (k_l, m_mat, v, g)):
        raise ValueError("query_side_bwd: q, k_l, m_mat, v and g must share an "
                         "fp32 or bf16 dtype")
    if delta.dtype != torch.float32:
        raise ValueError("query_side_bwd: delta must be fp32")
    check_head_dims("query_side_bwd", d, dv)
    if q.dtype == torch.bfloat16:
        check_tensor_core_shapes("query_side_bwd",
                                 {"q": q, "k_l": k_l, "m_mat": m_mat, "v": v, "g": g},
                                 {"d": d, "dv": dv})
    dq = torch.empty_like(q)
    dv_out = torch.empty_like(v)
    dkl = torch.empty_like(k_l)
    dm = torch.empty_like(m_mat)
    dd = torch.empty((b, 1, 1), dtype=torch.float32, device=q.device)
    plan = query_side_bwd_plan(b, n, run_rows=run_rows)
    parts = b * plan.runs
    ws = torch.empty(plan.workspace_floats(c, d, dv), dtype=torch.float32,
                     device=q.device)
    ws_k, ws_m, ws_d = ws.split([parts * c * d, parts * c * dv, parts])
    stats = ws_dq = None
    if c > ROW_TILE:
        # past 64 landmark columns: each row's fp32 (m, l, D) from the first
        # pass, and dQ's fp32 partials per landmark tile
        stats = torch.empty(3 * b * n, dtype=torch.float32, device=q.device)
        ws_dq = torch.empty(b * -(-c // ROW_TILE) * n * d, dtype=torch.float32,
                            device=q.device)
    if b and n:
        launch("query_side_bwd", q.data_ptr(), k_l.data_ptr(), m_mat.data_ptr(),
               v.data_ptr(), delta.data_ptr(), g.data_ptr(), dq.data_ptr(),
               dkl.data_ptr(), dm.data_ptr(), dv_out.data_ptr(), dd.data_ptr(),
               ws_k.data_ptr(), ws_m.data_ptr(), ws_d.data_ptr(),
               stats.data_ptr() if stats is not None else None,
               ws_dq.data_ptr() if ws_dq is not None else None, b, n, c, d, dv,
               float(scale), seg, pos_offset, plan.run_rows,
               DTYPE_CODES[str(q.dtype)], _stream_handle(q))
        query_side_bwd.launches += 1
    return dq, dkl, dm, dv_out, dd


query_side_bwd.launches = 0
