"""Port kernel modules against the JAX reference, on the CPU.

The plain PyTorch versions of K1 (landmark_summary), K2 (query_side) and
K5 (paged_row_stats_lanes) -- what each CUDA wrapper runs for a CPU tensor
-- are held against the Pallas kernels in interpret mode on the same numpy
inputs, in fp32. Tolerance: atol 1e-5, rtol 1e-4; the kernels stream keys
in blocks with an online softmax while the plain versions take one softmax,
so sums are taken in another order. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.attention import SSConfig as JSSConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.paged_decode import paged_row_stats_lanes as j_paged  # noqa: E402
from repro.kernels.ss_attention import landmark_summary as j_ls  # noqa: E402
from repro.kernels.ss_attention import query_side as j_qs  # noqa: E402
from repro_torch.core.attention import SSConfig  # noqa: E402
from repro_torch.kernels import HEAD_DIM_LIMITS, build, launch_counts  # noqa: E402
from repro_torch.kernels import ops, paged_decode  # noqa: E402
from repro_torch.kernels.paged_decode import (SLOT_TARGET_CTAS,  # noqa: E402
                                              paged_row_stats_lanes,
                                              paged_row_stats_plain,
                                              slot_chunk_plan)
from repro_torch.kernels.ref import ref_landmark_summary, ref_query_side  # noqa: E402
from repro_torch.kernels.ss_attention import (KEY_TILE, QUERY_TILE,  # noqa: E402
                                              ROW_TILE, TARGET_CTAS,
                                              b_side_mask, chunk_plan,
                                              landmark_summary,
                                              landmark_summary_plain, query_side,
                                              query_tile_plan)
from repro_torch.kernels.ss_attention_bwd import (QS_BWD_STEP_ROWS,  # noqa: E402
                                                  QS_BWD_TARGET_CTAS,
                                                  query_side_bwd_plan)

TOL = dict(atol=1e-5, rtol=1e-4)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref, np.float32),
                               **(tol or TOL))


# --------------------------------------------------------------------------
# K1: landmark_summary
# --------------------------------------------------------------------------
K1_CASES = {
    # name: (n, c, block_n, kwargs)
    "ragged_n": (500, 16, 128, {}),
    "kv_valid_in_last_block": (384, 16, 128, {"kv_valid": 333}),
    "segment_causal": (256, 16, 64, {"causal": True}),
    # rows 0 and 1 see global keys < 16 and < 32 but the local keys start at
    # 40: fully masked in their first (and every) block; row 2 is partial.
    # The port's wrapper takes no kv_offset (only the reference's sharded
    # driver passes one), so this case holds the plain version directly.
    "rows_fully_masked": (128, 16, 32, {"causal": True, "kv_offset": 40,
                                        "seq_len_k": 256}),
}


def _port_landmark_summary(q_l, k, v, scale, stats, kw):
    if "kv_offset" not in kw:
        return landmark_summary(q_l, k, v, scale=scale, return_stats=stats, **kw)
    seg = -(-kw["seq_len_k"] // q_l.shape[1]) if kw.get("causal") else 0
    return landmark_summary_plain(q_l, k, v, scale=scale, seg=seg,
                                  kv_offset=kw["kv_offset"], return_stats=stats)


@pytest.mark.parametrize("case", sorted(K1_CASES))
@pytest.mark.parametrize("stats", [False, True])
def test_landmark_summary_plain_matches_pallas(case, stats):
    n, c, block_n, kw = K1_CASES[case]
    rng = np.random.default_rng(1)
    q_l, k, v = _rand(rng, 3, c, 32, scale=0.5), _rand(rng, 3, n, 32, scale=0.5), _rand(rng, 3, n, 48)
    scale = 32**-0.5
    ref = j_ls(jnp.asarray(q_l), jnp.asarray(k), jnp.asarray(v), scale=scale,
               block_n=block_n, interpret=True, return_stats=stats, **kw)
    out = _port_landmark_summary(torch.from_numpy(q_l), torch.from_numpy(k),
                                 torch.from_numpy(v), scale, stats, kw)
    if not stats:
        _close(out, ref)
        return
    for o, r in zip(out, ref):
        _close(o, r)
    if case == "rows_fully_masked":
        m, l = out[1], out[2]
        assert torch.all(m[:, :2] == -1e30) and torch.all(l[:, :2] == 0)
        assert torch.all(out[0][:, :2] == 0) and torch.all(l[:, 2] > 0)


def test_landmark_summary_plain_matches_unmasked_oracle():
    rng = np.random.default_rng(2)
    q_l, k, v = (torch.from_numpy(_rand(rng, 2, 16, 32)),
                 torch.from_numpy(_rand(rng, 2, 200, 32)),
                 torch.from_numpy(_rand(rng, 2, 200, 32)))
    out = landmark_summary(q_l, k, v, scale=0.2)
    torch.testing.assert_close(out, ref_landmark_summary(q_l, k, v, 0.2), **TOL)


# --------------------------------------------------------------------------
# The split-key grid of the bf16 K1 / K3 kernels (csrc/mma.cuh)
# --------------------------------------------------------------------------
PLAN_CASES = {
    # name: (b, c, n, seg, kv_end)
    "train_qwen2_7b": (56, 64, 4096, 64, None),
    "serve_bucket_333": (28, 64, 352, 0, 333),
    "serve_512": (28, 64, 512, 0, None),
    "kv_valid_first_chunk": (56, 64, 4096, 0, 40),
    "kv_valid_ragged": (56, 64, 4096, 0, 1000),
    "c16_causal": (2, 16, 4096, 256, None),
    "c32_causal_kv_valid": (3, 32, 384, 12, 333),
    "c128_two_row_tiles": (4, 128, 1024, 8, None),
    "kv_valid_zero": (3, 16, 384, 0, 0),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_chunk_plan_covers_the_keys_once(case):
    b, c, n, seg, kv_end = PLAN_CASES[case]
    plan = chunk_plan(b, c, n, seg=seg, kv_end=kv_end)
    n_end = min(n if kv_end is None else kv_end, c * seg if seg else n)
    assert plan.n_end == n_end and plan.chunk_keys % KEY_TILE == 0
    bounds = [plan.bounds(i) for i in range(plan.chunks)]
    # chunks tile [0, n_end) in order, none empty
    assert [lo for lo, _ in bounds] == [i * plan.chunk_keys for i in range(plan.chunks)]
    assert all(lo < hi for lo, hi in bounds)
    assert (bounds[-1][1] if bounds else 0) == n_end
    assert all(hi - lo == plan.chunk_keys for lo, hi in bounds[:-1])
    # enough CTAs to fill the card, but never a chunk below one tile
    ctas = plan.chunks * -(-c // ROW_TILE) * b
    assert plan.chunk_keys == KEY_TILE or ctas >= TARGET_CTAS // 2
    # row r reaches chunk i (its partial is written and merged) iff r >= first_row(i)
    for i in range(plan.chunks):
        reaching = [r for r in range(c) if i < plan.row_chunks(r)]
        assert reaching == list(range(plan.first_row(i), c))
        assert plan.first_row(i) < c
    floats = plan.workspace_floats(130)
    assert floats == (b * plan.chunks * c * 130 if plan.chunks > 1 else 0)


def test_chunk_plan_at_the_main_paths():
    train = chunk_plan(56, 64, 4096, seg=64)
    assert (train.chunk_keys, train.chunks) == (448, 10)
    # K1's (m, l, acc) partials at the training shape: 18.6 MB
    assert train.workspace_floats(128 + 2) * 4 == 18_636_800
    serve = chunk_plan(28, 64, 352, kv_end=333)
    assert (serve.chunk_keys, serve.chunks) == (64, 6)
    assert chunk_plan(56, 64, 4096, kv_end=40).chunks == 1   # direct write
    assert chunk_plan(3, 16, 384, kv_end=0).chunks == 0      # merge writes the empty rows


def test_tile_sizes_match_the_cuda_header():
    src = (build.CSRC / "mma.cuh").read_text()
    assert int(re.search(r"kTileRows = (\d+);", src).group(1)) == ROW_TILE == KEY_TILE


def split_key_landmark_summary(q_l, k, v, plan, scale, *, all_chunks=False):
    """Plain mirror of the bf16 K1 kernel's decomposition: fp32 partials
    (m, l, acc) of each chunk's keys (m = -1e30, l = 0, acc = 0 for a row
    with no valid key in it), merged in chunk order by flash_merge's rule
    over the chunks each row reaches (``all_chunks``: over every chunk)."""
    b, c, _ = q_l.shape
    mask = b_side_mask(c, k.shape[1], seg=plan.seg, kv_end=plan.n_end)
    s = torch.einsum("bcd,bnd->bcn", q_l, k) * scale
    ms, ls, accs = [], [], []
    for i in range(plan.chunks):
        lo, hi = plan.bounds(i)
        si = torch.where(mask[:, lo:hi], s[..., lo:hi], -1e30)
        m = si.amax(dim=-1, keepdim=True)
        p = torch.where(mask[:, lo:hi], torch.exp(si - m), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bcn,bnd->bcd", p, v[:, lo:hi]))
    reached = torch.tensor([plan.row_chunks(r) for r in range(c)])[:, None]
    m_tot = torch.full((b, c, 1), -1e30)
    for i, m in enumerate(ms):
        m_tot = torch.where((i < reached) | all_chunks, torch.maximum(m_tot, m), m_tot)
    l_tot, acc = torch.zeros((b, c, 1)), torch.zeros((b, c, v.shape[2]))
    for i, (m, l, a) in enumerate(zip(ms, ls, accs)):
        corr = torch.where((i < reached) | all_chunks, torch.exp(m - m_tot), 0.0)
        l_tot, acc = l_tot + l * corr, acc + a * corr
    return acc / torch.clamp(l_tot, min=1e-30), m_tot, l_tot


@pytest.mark.parametrize("case", ["c16_causal_n256", "kv_valid_333", "c32_causal_kv_valid",
                                  "kv_valid_zero"])
@pytest.mark.parametrize("all_chunks", [False, True], ids=["reached", "every_chunk"])
def test_split_key_merge_matches_plain(case, all_chunks):
    b, c, n, causal, kv_valid = {"c16_causal_n256": (3, 16, 256, True, None),
                                 "kv_valid_333": (3, 16, 384, False, 333),
                                 "c32_causal_kv_valid": (3, 32, 384, True, 333),
                                 "kv_valid_zero": (3, 16, 384, False, 0)}[case]
    rng = np.random.default_rng(9)
    q_l, k, v = (torch.from_numpy(_rand(rng, b, c, 32, scale=0.5)),
                 torch.from_numpy(_rand(rng, b, n, 32, scale=0.5)),
                 torch.from_numpy(_rand(rng, b, n, 48)))
    seg = -(-n // c) if causal else 0
    end = n if kv_valid is None else kv_valid
    plan = chunk_plan(b, c, n, seg=seg, kv_end=end)
    assert plan.chunks > 1 or end == 0
    if causal:   # row 0 reaches only the first chunk: later ones hold no valid key for it
        assert plan.row_chunks(0) == 1 < plan.chunks
    out, m, l = split_key_landmark_summary(q_l, k, v, plan, 32**-0.5,
                                           all_chunks=all_chunks)
    ref = landmark_summary_plain(q_l, k, v, scale=32**-0.5, seg=seg, kv_end=end,
                                 return_stats=True)
    for o, r in zip((out, m, l), ref):
        _close(o, r)
    if end == 0:
        assert torch.all(m == -1e30) and torch.all(l == 0) and torch.all(out == 0)


# --------------------------------------------------------------------------
# K2: query_side
# --------------------------------------------------------------------------
K2_CASES = {
    # name: (n, c, block_n, kwargs)
    "ragged_n": (500, 16, 128, {}),
    "causal_static_offset": (200, 16, 64, {"causal": True, "seq_len_k": 300}),
    "causal_q_offset": (160, 16, 64, {"causal": True, "seq_len_k": 512,
                                      "q_offset": 37}),
}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_query_side_plain_matches_pallas(case):
    n, c, block_n, kw = K2_CASES[case]
    rng = np.random.default_rng(3)
    q, k_l = _rand(rng, 2, n, 32, scale=0.5), _rand(rng, 2, c, 32, scale=0.5)
    m_mat, v = _rand(rng, 2, c, 24), _rand(rng, 2, n, 24)
    delta = np.abs(_rand(rng, 2, 1, 1)) * 0.1
    scale = 32**-0.5
    ref = j_qs(*(jnp.asarray(a) for a in (q, k_l, m_mat, v, delta)),
               scale=scale, block_n=block_n, interpret=True, **kw)
    out = query_side(*(torch.from_numpy(a) for a in (q, k_l, m_mat, v, delta)),
                     scale=scale, **kw)
    _close(out, ref)


def test_query_side_plain_matches_unmasked_oracle():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(_rand(rng, *s)) for s in
            ((2, 70, 32), (2, 16, 32), (2, 16, 32), (2, 70, 32), (2, 1, 1))]
    torch.testing.assert_close(query_side(*args, scale=0.3),
                               ref_query_side(*args, 0.3), **TOL)


# --------------------------------------------------------------------------
# The query-tile runs of the bf16 K2 / K4 kernels
# --------------------------------------------------------------------------
QUERY_PLAN_CASES = {
    # name: (b, n)
    "train_qwen2_7b": (56, 4096),
    "serve_bucket_352": (28, 352),
    "serve_512": (28, 512),
    "one_row": (56, 1),
    "under_a_tile": (56, 63),
    "one_past_a_tile": (56, 65),
    "ragged_4000": (56, 4000),
    "reduced_cpu": (6, 96),
}


@pytest.mark.parametrize("kernel", ["query_side", "query_side_bwd"])
@pytest.mark.parametrize("case", sorted(QUERY_PLAN_CASES))
def test_query_tile_plan_covers_each_row_once(case, kernel):
    b, n = QUERY_PLAN_CASES[case]
    if kernel == "query_side":
        plan, step, target = query_tile_plan(b, n), QUERY_TILE, TARGET_CTAS
    else:
        plan, step, target = query_side_bwd_plan(b, n), QS_BWD_STEP_ROWS, QS_BWD_TARGET_CTAS
    assert plan.step_rows == step and plan.run_rows % step == 0
    # every query row in exactly one run, runs in order, none empty
    owner = [i for r in range(plan.runs) for i in [r] * (plan.rows(r)[1] - plan.rows(r)[0])]
    assert owner == sorted(owner) and len(owner) == n
    assert all(lo < hi for lo, hi in map(plan.rows, range(plan.runs)))
    assert plan.rows(plan.runs - 1)[1] == n
    # enough CTAs to fill the card, but never a run below one step; K4 (one
    # CTA an SM) within one wave
    assert plan.run_rows == step or b * plan.runs >= target // 2
    if kernel == "query_side_bwd":
        assert plan.runs == 1 or b * plan.runs <= target
    assert plan.workspace_floats(64, 128, 96) == b * plan.runs * (64 * (128 + 96) + 1)


def test_query_tile_plan_at_the_main_paths():
    train = query_tile_plan(56, 4096)
    assert (train.run_rows, train.runs) == (448, 10)     # 7 tiles, 560 CTAs
    assert (query_tile_plan(28, 352).run_rows, query_tile_plan(28, 352).runs) == (64, 6)
    bwd = query_side_bwd_plan(56, 4096)
    assert (bwd.run_rows, bwd.runs) == (2048, 2)         # 16 steps, 112 CTAs: one wave
    # K4's partials of dK~, dM and ddelta at the training shape: 7.3 MB
    assert bwd.workspace_floats(64, 128, 128) * 4 == 7_340_480
    assert query_side_bwd_plan(28, 512).runs == 4          # the fp32 grad check's shape


@pytest.mark.parametrize("kernel", ["query_side", "query_side_bwd"])
@pytest.mark.parametrize("bad", ["d_not_multiple_of_8", "misaligned", "d_above_head_limit"])
def test_bf16_shapes_the_tensor_core_kernels_do_not_take_raise(kernel, bad):
    """The bf16 K2 / K4 wrappers raise before any launch on a shape their
    tensor-core kernels do not take: there is no FMA fallback for bf16.
    (Any landmark count c is taken: K2 and K4 tile it past 64.)"""
    from repro_torch.kernels import ss_attention, ss_attention_bwd

    b, n, c, d = 2, 70, 16, {"d_not_multiple_of_8": 12, "misaligned": 16,
                             "d_above_head_limit": HEAD_DIM_LIMITS[kernel][0] + 8}[bad]

    def t(*shape):
        if bad == "misaligned":   # one bf16 past a 16-byte boundary
            return torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16)[1:].view(shape)
        return torch.zeros(shape, dtype=torch.bfloat16)

    args = [t(b, n, d), t(b, c, d), t(b, c, d), t(b, n, d), torch.ones(b, 1, 1)]
    before = launch_counts()
    with pytest.raises(ValueError):
        if kernel == "query_side":
            ss_attention._query_side_cuda(*args, scale=0.25, seg=0, pos_offset=0)
        else:
            ss_attention_bwd._query_side_bwd_cuda(*args, t(b, n, d), scale=0.25, seg=0,
                                                  pos_offset=0)
    assert launch_counts() == before


def test_query_tile_sizes_match_the_cuda_source():
    src = (build.CSRC / "query_side.cu").read_text()
    assert int(re.search(r"kStepRows = (\d+);", src).group(1)) == QUERY_TILE == ROW_TILE


# --------------------------------------------------------------------------
# K5: paged_row_stats_lanes
# --------------------------------------------------------------------------
def _paged_inputs(rng, splits):
    lanes, hkv, r, bs, n_slots, nb, dv = 3, 2, 7, 8, 6, 20, 16
    q = _rand(rng, lanes, hkv, r, sum(splits), scale=0.5)
    k_pools = [_rand(rng, hkv, nb, bs, dp, scale=0.5) for dp in splits]
    v_pool = _rand(rng, hkv, nb, bs, dv)
    # distinct blocks per lane; slots past the allocation hold ZERO_BLOCK
    perm = rng.permutation(np.arange(1, nb))
    table = np.zeros((lanes, n_slots), np.int32)
    table[0, :2] = perm[:2]        # kv_valid 0: allocated but nothing valid
    table[1, :2] = perm[2:4]       # kv_valid 13: ragged second block
    table[2, :5] = perm[4:9]       # kv_valid 37: ragged fifth block
    kv_valid = np.array([0, 13, 37], np.int32)
    return q, k_pools, v_pool, table, kv_valid, bs


@pytest.mark.parametrize("splits", [(32,), (24, 8)], ids=["one_pool", "two_pools"])
def test_paged_row_stats_plain_matches_pallas(splits):
    rng = np.random.default_rng(5)
    q, k_pools, v_pool, table, kv_valid, bs = _paged_inputs(rng, splits)
    scale = 0.2
    ref = j_paged(jnp.asarray(q), tuple(jnp.asarray(p) for p in k_pools),
                  jnp.asarray(v_pool), jnp.asarray(table), jnp.asarray(kv_valid),
                  scale=scale, block_size=bs, interpret=True)
    args = (torch.from_numpy(q), tuple(torch.from_numpy(p) for p in k_pools),
            torch.from_numpy(v_pool), torch.from_numpy(table),
            torch.from_numpy(kv_valid))
    out = paged_row_stats_plain(*args, scale=scale)
    for o, r in zip(out, ref):
        _close(o, r)
    # the wrapper (one or two key pools) runs the same plain version
    wrapped = paged_row_stats_lanes(*args, scale=scale, block_size=bs)
    for o, w in zip(out, wrapped):
        torch.testing.assert_close(w, o, rtol=0, atol=0)
    m, l, acc = out
    # zero valid keys: exactly the absorbing anchor
    assert torch.all(m[0] == -1e30) and torch.all(l[0] == 0) and torch.all(acc[0] == 0)


@pytest.mark.parametrize("bs", [48, 64])
def test_paged_row_stats_plain_matches_pallas_at_48_rows(bs):
    """granite-20b's decode rows: 48 query rows on one kv head, blocks of 48
    and 64 keys; kv_valid 0, 31, 33 (either side of a 32-key slice's
    edge), a ragged third block and every slot."""
    rng = np.random.default_rng(17)
    lanes, hkv, r, d, n_slots, nb = 5, 1, 48, 16, 4, 22
    q = _rand(rng, lanes, hkv, r, d, scale=0.5)
    k_pool, v_pool = _rand(rng, hkv, nb, bs, d, scale=0.5), _rand(rng, hkv, nb, bs, d)
    table = rng.permutation(np.arange(1, nb))[:lanes * n_slots].reshape(
        lanes, n_slots).astype(np.int32)
    kv_valid = np.array([0, 31, 33, 2 * bs + 7, n_slots * bs], np.int32)
    ref = j_paged(jnp.asarray(q), (jnp.asarray(k_pool),), jnp.asarray(v_pool),
                  jnp.asarray(table), jnp.asarray(kv_valid), scale=0.25,
                  block_size=bs, interpret=True)
    out = paged_row_stats_lanes(torch.from_numpy(q), (torch.from_numpy(k_pool),),
                                *(torch.from_numpy(a) for a in (v_pool, table, kv_valid)),
                                scale=0.25, block_size=bs)
    for o, r_ in zip(out, ref):
        _close(o, r_)
    assert torch.all(out[0][0] == -1e30) and torch.all(out[1][0] == 0)


# --------------------------------------------------------------------------
# The split-slot grid of the K5 kernel
# --------------------------------------------------------------------------
SLOT_PLAN_CASES = {
    # name: (lanes, hkv, n_slots, block_size)
    "one_slot": (4, 4, 1, 16),
    "serve_512": (4, 4, 32, 16),
    "horizon_16k": (4, 4, 1024, 16),
    "horizon_8k": (4, 4, 512, 16),
    "kv_heads_8": (4, 8, 1024, 16),
    "block_8": (3, 2, 6, 8),
    "block_32": (4, 4, 512, 32),
    "block_12": (2, 4, 100, 12),
    "no_slots": (2, 2, 0, 16),
    "block_24": (4, 4, 100, 24),
    "block_48": (4, 4, 43, 48),
    "block_64_granite": (4, 1, 256, 64),
    "block_128": (3, 2, 16, 128),
}


@pytest.mark.parametrize("case", sorted(SLOT_PLAN_CASES))
def test_slot_chunk_plan_covers_every_slot_once(case):
    lanes, hkv, n_slots, bs = SLOT_PLAN_CASES[case]
    plan = slot_chunk_plan(lanes, hkv, n_slots, bs)
    # chunks are whole steps of the kernel: 32 // bs blocks (bs <= 32) or
    # one block (bs > 32), so their edges lie at whole blocks
    assert plan.step_slots == max(1, 32 // bs) and plan.chunk_slots % plan.step_slots == 0
    assert plan.chunks >= 1
    # the kernel's steps cover each chunk's keys once, in order, each of
    # at most 32 keys: whole blocks, or 32-key slices of one block
    for i in range(plan.chunks):
        lo, hi = plan.slots(i)
        steps = plan.steps(i)
        keys = [(s * bs + k0 + j) for s, nbk, k0, nk in steps for j in range(nk)]
        assert keys == list(range(lo * bs, hi * bs))
        assert all(0 < nk <= 32 for *_, nk in steps)
        assert all(nbk == 1 and nk == min(32, bs - k0) for _, nbk, k0, nk in steps) \
            if bs > 32 else all(k0 == 0 and nk == nbk * bs for _, nbk, k0, nk in steps)
    # every slot of a lane in exactly one chunk, chunks in order, none empty
    owner = [i for i in range(plan.chunks) for _ in range(*plan.slots(i))]
    assert owner == sorted(owner) and len(owner) == n_slots
    assert n_slots == 0 or all(lo < hi for lo, hi in map(plan.slots, range(plan.chunks)))
    assert all(hi - lo == plan.chunk_slots
               for lo, hi in map(plan.slots, range(plan.chunks - 1)))
    # CTAs near the target: at least half of it unless every chunk is one
    # step, and never a chunk's worth past it
    ctas = lanes * hkv * plan.chunks
    assert plan.chunk_slots == plan.step_slots or ctas >= SLOT_TARGET_CTAS // 2
    assert ctas <= SLOT_TARGET_CTAS + lanes * hkv
    floats = plan.workspace_floats(7, 128)
    assert floats == (lanes * hkv * plan.chunks * 7 * 130 if plan.chunks > 1 else 0)


def test_slot_chunk_plan_at_the_main_paths():
    serve = slot_chunk_plan(4, 4, 32, 16)      # max_seq 512, block 16
    assert (serve.chunk_slots, serve.chunks) == (2, 16)        # one step each, 256 CTAs
    # the partials of (m, l, acc) at r = 7, dv = 128: 0.93 MB
    assert serve.workspace_floats(7, 128) * 4 == 931_840
    long = slot_chunk_plan(4, 4, 1024, 16)     # a 16k horizon
    assert (long.chunk_slots, long.chunks) == (32, 32)         # 512 CTAs
    assert slot_chunk_plan(4, 4, 1, 16).chunks == 1             # direct write
    assert slot_chunk_plan(4, 4, 1, 16).workspace_floats(7, 128) == 0
    # granite-20b's decode (4 lanes, 1 kv head, 64-key blocks, r = 48): one
    # block a chunk at 512 keys (32 CTAs), two at a 16k horizon (512 CTAs)
    granite = slot_chunk_plan(4, 1, 8, 64)
    assert (granite.step_slots, granite.chunk_slots, granite.chunks) == (1, 1, 8)
    assert granite.steps(0) == [(0, 1, 0, 32), (0, 1, 32, 32)]
    assert (slot_chunk_plan(4, 1, 256, 64).chunk_slots,
            slot_chunk_plan(4, 1, 256, 64).chunks) == (2, 128)


def split_slot_row_stats(q, k_pool, v_pool, table, kv_valid, plan, bs, scale):
    """Plain mirror of the K5 kernel's decomposition: per (lane, kv head),
    each chunk walks its valid slots in the plan's steps (``plan.steps``:
    32 // bs whole blocks, or 32-key slices of a block past 32 keys) up to
    kv_valid, with an online softmax over steps (one max and one rescale
    per step) into fp32 partials, the anchor (m -1e30, l 0, acc 0) for a
    chunk with no valid key; the partials merge in chunk order by
    flash_merge's rule. Only the rows of valid keys are read."""
    lanes, hkv, r, _ = q.shape
    dv = v_pool.shape[-1]
    m_out, l_out = torch.empty((lanes, hkv, r, 1)), torch.empty((lanes, hkv, r, 1))
    acc_out = torch.empty((lanes, hkv, r, dv))
    for ln in range(lanes):
        valid = min(max(int(kv_valid[ln]), 0), plan.n_slots * bs)
        n_blk = -(-valid // bs)
        for h in range(hkv):
            parts = []
            for c in range(plan.chunks):
                m, l, acc = torch.full((r, 1), -1e30), torch.zeros((r, 1)), torch.zeros((r, dv))
                for s0, nbk, k0, nk in plan.steps(c, n_blk):
                    kend = min(nk, valid - (s0 * bs + k0))        # keys past kend unread
                    if kend <= 0:
                        continue
                    blks = [int(b) for b in table[ln, s0:s0 + nbk]]
                    k = torch.cat([k_pool[h, b] for b in blks])[k0:k0 + kend]
                    v = torch.cat([v_pool[h, b] for b in blks])[k0:k0 + kend]
                    s = (q[ln, h] * scale) @ k.T                     # (r, kend)
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    p, corr = torch.exp(s - m_new), torch.exp(m - m_new)
                    l, acc, m = l * corr + p.sum(-1, keepdim=True), acc * corr + p @ v, m_new
                parts.append((m, l, acc))
            mx = torch.stack([p[0] for p in parts]).amax(0)
            m_out[ln, h] = mx
            l_out[ln, h] = sum(p[1] * torch.exp(p[0] - mx) for p in parts)
            acc_out[ln, h] = sum(p[2] * torch.exp(p[0] - mx) for p in parts)
    return m_out, l_out, acc_out


# (chunk steps, block size) -> kv heads for which slot_chunk_plan cuts a
# table of 12 slots over 4 lanes into chunks of that many steps (more
# (lane, kv head) pairs leave fewer chunks to each)
SPLIT_SLOT_HKV = {(1, 8): 2, (2, 8): 66, (3, 8): 132, (1, 16): 2, (2, 16): 44,
                  (3, 16): 66, (1, 48): 2, (2, 48): 22, (3, 48): 33, (1, 64): 2,
                  (2, 64): 22, (3, 64): 33}


@pytest.mark.parametrize("bs", [8, 16, 48, 64])
@pytest.mark.parametrize("chunk_steps", [1, 2, 3])
def test_split_slot_merge_matches_plain_and_pallas(chunk_steps, bs):
    """The kernel's decomposition at chunks of 1, 2 and 3 steps over a
    table of 12 slots: lanes of kv_valid 0 (one block allocated, none
    valid), 13 (a ragged first or second block, later chunks wholly past
    it), a ragged last block (past 32 keys: in its block's second 32-key
    slice), and every slot valid; the ZERO_BLOCK tail."""
    rng = np.random.default_rng(10)
    lanes, r, d, dv, n_slots = 4, 7, 32, 16, 12
    hkv = SPLIT_SLOT_HKV[chunk_steps, bs]
    kv_valid = np.array([0, 13, 9 * bs + (5 if bs <= 32 else 37), n_slots * bs], np.int32)
    used = [1, -(-13 // bs), 10, n_slots]
    nb = sum(used) + 2
    perm = rng.permutation(np.arange(1, nb))
    table = np.zeros((lanes, n_slots), np.int32)
    at = 0
    for ln, u in enumerate(used):
        table[ln, :u] = perm[at:at + u]
        at += u
    q = _rand(rng, lanes, hkv, r, d, scale=0.5)
    k_pool, v_pool = _rand(rng, hkv, nb, bs, d, scale=0.5), _rand(rng, hkv, nb, bs, dv)
    plan = slot_chunk_plan(lanes, hkv, n_slots, bs)
    assert plan.chunk_slots == max(1, 32 // bs) * chunk_steps
    # lane 1 (kv_valid 13) leaves chunks wholly past its keys
    assert plan.chunks == 1 or plan.slots(plan.chunks - 1)[0] * bs > 13
    scale = 0.2
    t = [torch.from_numpy(a) for a in (q, k_pool, v_pool, table, kv_valid)]
    out = split_slot_row_stats(*t, plan, bs, scale)
    ref = paged_row_stats_plain(t[0], (t[1],), *t[2:], scale=scale)
    pallas = j_paged(jnp.asarray(q), (jnp.asarray(k_pool),), jnp.asarray(v_pool),
                     jnp.asarray(table), jnp.asarray(kv_valid), scale=scale,
                     block_size=bs, interpret=True)
    for o, r_, p in zip(out, ref, pallas):
        _close(o, r_)
        _close(o, p)
    m, l, acc = out
    assert torch.all(m[0] == -1e30) and torch.all(l[0] == 0) and torch.all(acc[0] == 0)
    # no row past a lane's last valid key is read: poisoning them (the
    # ZERO_BLOCK tail, the kv_valid-0 lane's block, an unused pool block,
    # the ragged blocks' tails) leaves every bit unchanged
    keep = torch.zeros((nb, bs), dtype=torch.bool)
    for ln in range(lanes):
        for slot in range(-(-int(kv_valid[ln]) // bs)):
            keep[int(table[ln, slot]), :min(bs, int(kv_valid[ln]) - slot * bs)] = True
    assert not keep[0].any() and not keep.all()
    kp = torch.where(keep[None, :, :, None], t[1], float("nan"))
    vp = torch.where(keep[None, :, :, None], t[2], float("nan"))
    again = split_slot_row_stats(t[0], kp, vp, t[3], t[4], plan, bs, scale)
    for o, a in zip(out, again):
        assert torch.equal(o, a)


def test_slot_chunk_limits_match_the_cuda_source():
    src = (build.CSRC / "paged_row_stats.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    # a step holds up to 32 keys, one per lane
    assert const("kStepKeys") == paged_decode._STEP_KEYS == 32
    # a CTA takes 64 query rows: warp w rows w, w + 8, ... (the largest
    # rows-per-warp instance); more rows take more CTAs
    assert (const("kMaxRows") == paged_decode._ROWS_PER_CTA
            == const("kThreads") // 32 * const("kMaxRowsPerWarp"))
    # step i-1's stage of the ring is refilled only after step i's wait:
    # one stage would wait for a copy not yet issued
    assert const("kStages") >= 2


@pytest.mark.parametrize("source", sorted(build.SOURCES))
def test_every_kernel_takes_max_head_dim(source):
    """The head-dim limits the wrappers and the serving engine hold each
    kernel to are the kernel's own: a .cu file with wide-head variants
    takes (kWideMaxD, kWideMaxDv), one without them (kMaxD, kMaxD), and
    that pair is the file's entry of HEAD_DIM_LIMITS."""
    src = (build.CSRC / f"{source}.cu").read_text()

    def const(name):
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert len(found) <= 1, f"{source}.cu defines {name} more than once"
        return int(found[0]) if found else None

    narrow = const("kMaxD")
    assert narrow == 128
    wide = (const("kWideMaxD"), const("kWideMaxDv"))
    limits = wide if wide != (None, None) else (narrow, narrow)
    assert limits == HEAD_DIM_LIMITS[source]


K5_BAD_OPERANDS = {
    # name: (r, d, dv, bs, misaligned, dtype)
    "value_dim_above_512": (9, 32, 516, 8, False, torch.float32),
    "head_dim_above_576": (2, 580, 32, 8, False, torch.float32),
    "bf16_block_not_16_byte_units": (48, 4, 4, 33, False, torch.bfloat16),
    "head_dim_not_multiple_of_4": (2, 30, 32, 8, False, torch.float32),
    "misaligned_pool": (2, 32, 32, 8, True, torch.float32),
}


@pytest.mark.parametrize("case", sorted(K5_BAD_OPERANDS))
def test_k5_operands_the_kernel_does_not_take_raise(case):
    """The K5 launch path raises before any launch on operands its kernel
    does not take: there is no fallback to the plain version."""
    r, d, dv, bs, misaligned, dtype = K5_BAD_OPERANDS[case]
    lanes, hkv, nb, n_slots = 2, 2, 5, 2

    def pool(e):
        shape = (hkv, nb, bs, e)
        if misaligned:   # one fp32 past a 16-byte boundary
            return torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)[1:].view(shape)
        return torch.zeros(shape, dtype=dtype)

    before = launch_counts()
    with pytest.raises(ValueError):
        paged_decode._paged_row_stats_cuda(
            torch.zeros(lanes, hkv, r, d, dtype=dtype), (pool(d),), pool(dv),
            torch.zeros(lanes, n_slots, dtype=torch.int32),
            torch.zeros(lanes, dtype=torch.int32), scale=0.5)
    assert launch_counts() == before


def test_cpu_tensors_never_launch_a_kernel():
    before = launch_counts()
    rng = np.random.default_rng(6)
    landmark_summary(torch.from_numpy(_rand(rng, 1, 4, 8)),
                     torch.from_numpy(_rand(rng, 1, 9, 8)),
                     torch.from_numpy(_rand(rng, 1, 9, 8)), scale=1.0)
    assert launch_counts() == before


# --------------------------------------------------------------------------
# ss_attention_fused (K1 + K2 + the c x c core)
# --------------------------------------------------------------------------
FUSED_CASES = {
    # name: (n, kv_valid, causal)
    "bidir": (100, None, False),
    "kv_valid": (128, 111, False),
    "segment_causal": (100, None, True),
    "n_le_c": (12, None, False),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_ss_attention_fused_matches_jax(case):
    n, kv_valid, causal = FUSED_CASES[case]
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, 2, 3, n, 32, scale=0.5) for _ in range(3))
    jcfg = JSSConfig(num_landmarks=16, causal=causal)
    ref = jops.ss_attention_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jcfg, interpret=True, block_n=64,
                                  kv_valid=kv_valid)
    out = ops.ss_attention_fused(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 SSConfig(num_landmarks=16, causal=causal),
                                 kv_valid=kv_valid)
    rows = slice(None) if kv_valid is None else slice(0, kv_valid)
    # the Newton-Schulz core amplifies fp32 summation-order differences
    _close(out[..., rows, :], np.asarray(ref)[..., rows, :], atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# Landmark helpers (core/landmarks.py) feeding the kernels
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,n_valid", [(100, None), (128, None), (12, None),
                                       (128, 111)])
@pytest.mark.parametrize("via_matmul", [False, True])
def test_landmark_helpers_match_jax(n, n_valid, via_matmul):
    from repro.core import landmarks as jl
    from repro_torch.core import landmarks as tl

    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 3, n, 32)
    if n_valid is None:
        ref = jl.segment_means(jnp.asarray(x), 16, via_matmul=via_matmul)
        out = tl.segment_means(torch.from_numpy(x), 16, via_matmul=via_matmul)
    else:
        ref = jl.masked_segment_means(jnp.asarray(x), 16, n_valid)
        out = tl.masked_segment_means(torch.from_numpy(x), 16, n_valid)
    _close(out, ref, atol=1e-6, rtol=1e-5)
    pos = np.arange(n)
    np.testing.assert_array_equal(
        tl.segment_of(torch.from_numpy(pos), n, 16).numpy(),
        np.asarray(jl.segment_of(jnp.asarray(pos), n, 16)))
    nv = n_valid or n
    np.testing.assert_array_equal(
        tl.segment_counts(nv, 16, -(-nv // 16), floor=0).numpy(),
        np.asarray(jl.segment_counts(nv, 16, -(-nv // 16), floor=0)))


# --------------------------------------------------------------------------
# The ctypes bindings agree with the C entry points (no nvcc needed)
# --------------------------------------------------------------------------
_C_TYPES = {"const void*": "P", "void*": "P", "int": "I", "float": "F"}
_CT = {build.ctypes.c_void_p: "P", build.ctypes.c_int: "I",
       build.ctypes.c_float: "F"}


@pytest.mark.parametrize("name", build.SOURCES)
def test_ctypes_argtypes_match_c_signature(name):
    src = (build.CSRC / f"{name}.cu").read_text()
    sig = re.search(rf'extern "C" int {name}_launch\((.*?)\)', src, re.S)
    assert sig, f"{name}.cu has no extern \"C\" {name}_launch"
    params = [re.sub(r"\s+\w+$", "", p.strip()) for p in sig.group(1).split(",")]
    assert [_C_TYPES[p] for p in params] == [_CT[t] for t in build.ARGTYPES[name]]


def test_library_path_tracks_sources():
    path = build.library_path("query_side")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path("query_side")
    assert path != build.library_path("landmark_summary")
    assert Path(build.CSRC / "common.cuh").exists()
