"""The work of each kernel: the bytes it must move and the operations it
must do, one definition for every reader.

Each ``*_cost`` returns ``(bytes, flops)`` for one launch: every input
read once and every output written once, and 2 flops a multiply-add of
the products over the pairs the masks attend (the work this launch's data
needs, not the most its shape could need). ``bound_ms`` turns them into
the least time an H100 could take (the larger of bytes over its memory
rate and flops over its peak for the type). ``chip_smoke.py`` computes its
bounds from these; ``register_flop_formulas`` gives
``torch.utils.flop_counter.FlopCounterMode`` the same formulas for the
custom ops of K1-K4 (``repro_torch::landmark_summary``, ``::query_side``,
their backward ops and the context-parallel ``::landmark_summary_sp``), so
a count over a step counts the kernels' products, whatever device runs
them (a kernel launched through ``ctypes`` is invisible to the counter).
K5 runs outside any counted step; its cost serves the bounds only.

Shapes: K1 / K3 b batch-heads, c landmark rows, n keys at global
positions ``kv_offset`` ..., d (scores) and dv (values) wide; K2 / K4 n
queries at global positions ``pos_offset`` ... against c landmark
columns.
"""
from __future__ import annotations

from typing import Optional

# the card's rates (H100 SXM, 700 W): HBM3 bytes a second, dense peak
# flops a second by type
H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """(ms, what binds): the larger of the bytes at the memory rate and the
    flops at ``dtype``'s peak."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def b_side_pairs(c: int, n: int, *, seg: int = 0, kv_offset: int = 0,
                 kv_end: Optional[int] = None) -> int:
    """Attended (row, key) pairs of one batch-head under K1 / K3's masks
    (``ss_attention.py:b_side_mask``): key j at ``kv_offset + j`` below
    ``kv_end`` and, with ``seg``, below (row + 1) * seg."""
    end = kv_offset + n if kv_end is None else min(int(kv_end), kv_offset + n)
    total = 0
    for r in range(c):
        reach = min(end, (r + 1) * seg) if seg else end
        total += max(0, reach - kv_offset)
    return total


def f_side_pairs(n: int, c: int, *, seg: int = 0, pos_offset: int = 0) -> int:
    """Attended (query, column) pairs of one batch-head under K2 / K4's
    F-mask: column r for the query at ``pos_offset + i`` iff
    r <= (pos_offset + i) // seg; every column without ``seg``."""
    if not seg:
        return n * c
    return sum(min(c, (pos_offset + i) // seg + 1) for i in range(n))


def landmark_summary_cost(b: int, c: int, keys: int, d: int, dv: int, pairs: int, *,
                          q_bytes: int, kv_bytes: int, out_bytes: int,
                          stats: bool) -> tuple[int, int]:
    """K1: q_l (b, c, d), the ``keys`` keys and values it reads, BV (b, c, dv)
    [+ fp32 m, l]; scores and BV over ``pairs`` (all batch-heads)."""
    nbytes = (q_bytes * b * c * d + kv_bytes * b * keys * (d + dv) + out_bytes * b * c * dv
              + (8 * b * c if stats else 0))
    return nbytes, 2 * pairs * (d + dv)


def landmark_summary_bwd_cost(b: int, c: int, keys: int, d: int, dv: int, pairs: int, *,
                              es: int) -> tuple[int, int]:
    """K3: reads q_l, BV, the cotangent, k, v (``es`` bytes an element) and
    fp32 m, l; writes dq_l, dk, dv; recomputes the scores and forms dP,
    dV, dK and dQ~ over ``pairs``."""
    reads = es * (b * c * d + 2 * b * c * dv + b * keys * (d + dv)) + 8 * b * c
    writes = es * (b * c * d + b * keys * (d + dv))
    return reads + writes, 2 * pairs * (3 * d + 2 * dv)


def query_side_cost(b: int, n: int, c: int, d: int, dv: int, pairs: int, *,
                    es: int) -> tuple[int, int]:
    """K2: reads q, v, K~, M and fp32 delta, writes out (b, n, dv); scores
    and P @ M over ``pairs``."""
    nbytes = es * (b * n * d + b * c * (d + dv) + 2 * b * n * dv) + 4 * b
    return nbytes, 2 * pairs * (d + dv)


def query_side_bwd_cost(b: int, n: int, c: int, d: int, dv: int, pairs: int, *,
                        es: int) -> tuple[int, int]:
    """K4: reads q, v, the cotangent, K~, M, delta; writes dq, dv, dK~, dM,
    ddelta; the scores, dP, dQ, dK~ and dM over ``pairs`` plus ddelta and
    dV's delta term over every (query, value) element."""
    reads = es * (b * n * d + 2 * b * n * dv + b * c * (d + dv)) + 4 * b
    writes = es * (b * n * (d + dv) + b * c * (d + dv)) + 4 * b
    return reads + writes, 2 * pairs * (3 * d + 2 * dv) + 4 * b * n * dv


def paged_row_stats_cost(kv_valid, hkv: int, r: int, d: int, dv: int, bs: int, *,
                         es: int = 4, v_is_key: bool = False) -> tuple[int, int]:
    """K5, one launch over lanes with ``kv_valid`` keys each: q and the valid
    keys' K and V rows read once (with ``v_is_key`` the values are the
    first dv columns of the keys, absorbed MLA's latent pool, not read
    again), the table entries and kv_valid, fp32 (m, l, acc) written once;
    2 r (d + dv) flops a key and kv head."""
    lanes, keys = len(kv_valid), sum(kv_valid)
    blocks = sum(-(-x // bs) for x in kv_valid)
    row = d if v_is_key else d + dv
    nbytes = (es * (lanes * hkv * r * d + keys * hkv * row) + 4 * (blocks + lanes)
              + 4 * lanes * hkv * r * (dv + 2))
    return nbytes, keys * hkv * r * 2 * (d + dv)


# --------------------------------------------------------------------------
# FLOP formulas of the custom ops (shapes in, as FlopCounterMode passes
# them).
# --------------------------------------------------------------------------
def _seg(causal: bool, seq_len_k: int, n: int, c: int) -> int:
    return -(-(seq_len_k or n) // c) if causal else 0


def _k1_flops(q_l, k, v, scale, causal, kv_valid=None, chunk_keys=0, row_block=0, *,
              out_shape=None, seq_len_k=0, kv_offset=0):
    b, c, d = q_l
    n, dv = k[1], v[2]
    end = kv_offset + n if kv_valid is None else min(int(kv_valid), kv_offset + n)
    pairs = b * b_side_pairs(c, n, seg=_seg(causal, seq_len_k, n, c),
                             kv_offset=kv_offset, kv_end=end)
    return 2 * pairs * (d + dv)


def _k1_bwd_flops(q_l, k, v, bv, m, l, g, scale, causal, kv_valid=None, seq_len_k=0,
                  kv_offset=0, chunk_keys=0, row_block=0, *, out_shape=None):
    b, c, d = q_l
    n, dv = k[1], v[2]
    end = kv_offset + n if kv_valid is None else min(int(kv_valid), kv_offset + n)
    pairs = b * b_side_pairs(c, n, seg=_seg(causal, seq_len_k, n, c),
                             kv_offset=kv_offset, kv_end=end)
    return 2 * pairs * (3 * d + 2 * dv)


def _k1_sp_flops(q_l, k, v, scale, causal, seq_len, kv_offset, chunk_keys=0, mesh_id=0,
                 axes="", *, out_shape=None):
    return _k1_flops(q_l, k, v, scale, causal, seq_len, seq_len_k=seq_len,
                     kv_offset=kv_offset)


def _q_offset(causal: bool, seq_len_k: int, n: int, q_offset) -> int:
    return ((seq_len_k or n) - n if q_offset is None else int(q_offset)) if causal else 0


def _k2_flops(q, k_l, m_mat, v, delta, scale, causal, seq_len_k, run_rows=0,
              q_offset=None, *, out_shape=None):
    b, n, d = q
    c, dv = k_l[1], v[2]
    pairs = b * f_side_pairs(n, c, seg=_seg(causal, seq_len_k, n, c),
                             pos_offset=_q_offset(causal, seq_len_k, n, q_offset))
    return 2 * pairs * (d + dv)


def _k2_bwd_flops(q, k_l, m_mat, v, delta, g, scale, causal, seq_len_k, q_offset=None,
                  run_rows=0, *, out_shape=None):
    b, n, d = q
    c, dv = k_l[1], v[2]
    pairs = b * f_side_pairs(n, c, seg=_seg(causal, seq_len_k, n, c),
                             pos_offset=_q_offset(causal, seq_len_k, n, q_offset))
    return 2 * pairs * (3 * d + 2 * dv) + 4 * b * n * dv


def register_flop_formulas() -> None:
    """Register K1-K4's formulas with ``torch.utils.flop_counter`` for the
    custom ops that run them (once a process; later calls do nothing)."""
    import torch
    from torch.utils import flop_counter

    import repro_torch.kernels.sharded  # noqa: F401  (defines landmark_summary_sp)
    import repro_torch.kernels.ops  # noqa: F401  (defines the other four)

    ops = torch.ops.repro_torch
    for op, formula in ((ops.landmark_summary, _k1_flops),
                        (ops.landmark_summary_bwd, _k1_bwd_flops),
                        (ops.landmark_summary_sp, _k1_sp_flops),
                        (ops.query_side, _k2_flops),
                        (ops.query_side_bwd, _k2_bwd_flops)):
        if op not in flop_counter.flop_registry:
            flop_counter.register_flop_formula(op)(formula)
