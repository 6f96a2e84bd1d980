"""Gather-free paged decode kernel K5: online-softmax row partials read
straight from the shared K/V block pools through per-lane block tables.

    paged_row_stats_lanes(q, k_pool, v_pool, table, kv_valid)
        -> fp32 (m, l, acc) of softmax(scale * q . K[0..kv_valid-1]) rows

mirrors ``repro/kernels/paged_decode.py:162``. Lanes are the leading batch
axis, so one launch serves every lane of a decode tick; the reference's
single-lane entry point and its ``custom_vmap`` rule have no counterpart.
Rows with no valid key return the absorbing anchor (m=-1e30, l=0, acc=0)
that ``kernels.ops.flash_merge`` re-anchors at the first merged score.
For CUDA tensors the wrapper launches ``csrc/paged_row_stats.cu`` or
raises; for CPU tensors it runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.attention import NEG_INF
from repro_torch.kernels.build import DTYPE_CODES, check_operands, launch

_MAX_D = 128   # head dims the CUDA kernel takes (d and dv)
_MAX_R = 8     # query rows per kv head the CUDA kernel keeps in registers


def paged_row_stats_plain(q, k_pools, v_pool, table, kv_valid, *,
                          scale: float):
    """Plain version of K5, mirroring ``repro/kernels/paged_decode.py:162``
    ``paged_row_stats_lanes`` (body ``_paged_row_stats_kernel`` :83): the
    lane's slots are gathered through ``table``, scores summed over the key
    pools (q's features split across them in order), keys at positions
    >= kv_valid[lane] masked with -1e30 and their weights zeroed."""
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


def paged_row_stats_lanes(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, table: torch.Tensor,
                          kv_valid: torch.Tensor, *, scale: float,
                          block_size: int):
    """One launch for all lanes. q (lanes, hkv, r, d); k_pool
    (hkv, num_blocks, bs, d); v_pool (hkv, num_blocks, bs, dv); table
    (lanes, n_slots) int32; kv_valid (lanes,) int32. Returns fp32
    (m, l, acc): (lanes, hkv, r, 1) x2 and (lanes, hkv, r, dv). The
    reference's several key pools (MLA) are one pool here: the dense
    family has one."""
    lanes, hkv, r, d = q.shape
    hp, nb, bs, dv = v_pool.shape
    if (bs != block_size or hp != hkv or k_pool.shape[:3] != v_pool.shape[:3]
            or k_pool.shape[-1] != d):
        raise ValueError("paged_row_stats_lanes: pool shapes disagree")
    if table.shape[0] != lanes or kv_valid.shape != (lanes,):
        raise ValueError("paged_row_stats_lanes: table/kv_valid need one row "
                         "per lane")
    if not q.is_cuda:
        return paged_row_stats_plain(q, (k_pool,), v_pool, table, kv_valid,
                                     scale=scale)
    return _paged_row_stats_cuda(q, k_pool, v_pool, table, kv_valid,
                                 scale=scale)


def _paged_row_stats_cuda(q, k_pool, v_pool, table, kv_valid, *, scale):
    """Check the operands and launch csrc/paged_row_stats.cu (the
    arguments of ``paged_row_stats_plain`` with one key pool)."""
    lanes, hkv, r, d = q.shape
    _, nb, bs, dv = v_pool.shape
    check_operands("paged_row_stats_lanes", {
        "q": q, "k_pool": k_pool, "v_pool": v_pool, "table": table,
        "kv_valid": kv_valid})
    dev = q.device
    if str(q.dtype) not in DTYPE_CODES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("paged_row_stats_lanes: q and the pools must share "
                         "an fp32 or bf16 dtype")
    if table.dtype != torch.int32 or kv_valid.dtype != torch.int32:
        raise ValueError("paged_row_stats_lanes: table and kv_valid must be "
                         "int32")
    if d > _MAX_D or dv > _MAX_D or r > _MAX_R:
        raise ValueError(f"paged_row_stats_lanes: (d={d}, dv={dv}, r={r}) "
                         f"exceed the kernel's ({_MAX_D}, {_MAX_D}, {_MAX_R})")
    m = torch.empty((lanes, hkv, r, 1), dtype=torch.float32, device=dev)
    l = torch.empty((lanes, hkv, r, 1), dtype=torch.float32, device=dev)
    acc = torch.empty((lanes, hkv, r, dv), dtype=torch.float32, device=dev)
    if lanes and hkv and r:
        launch("paged_row_stats", q.data_ptr(), k_pool.data_ptr(),
               v_pool.data_ptr(), table.data_ptr(), kv_valid.data_ptr(),
               m.data_ptr(), l.data_ptr(), acc.data_ptr(), lanes, hkv, r,
               d, dv, nb, bs, table.shape[1], float(scale),
               DTYPE_CODES[str(q.dtype)],
               torch.cuda.current_stream(dev).cuda_stream)
        paged_row_stats_lanes.launches += 1
    return m, l, acc


paged_row_stats_lanes.launches = 0
