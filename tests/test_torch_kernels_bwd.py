"""Port backward kernels against the JAX reference, on the CPU.

The plain PyTorch versions of K3 (landmark_summary_bwd) and K4
(query_side_bwd) -- what each CUDA wrapper runs for a CPU tensor -- are
held against the Pallas kernels in interpret mode on the same numpy
inputs, in fp32, at 1e-5 of each output's max-abs (the kernels sum over
key or query blocks, the plain versions in one product). The custom
ops that route ``ss_attention_fused`` through K1-K4 are held against
``jax.grad`` of the reference's ``ss_attention_fused(..., interpret=True)``.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""
from __future__ import annotations

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.attention import SSConfig as JSSConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ss_attention import landmark_summary as j_ls  # noqa: E402
from repro.kernels.ss_attention_bwd import landmark_summary_bwd as j_ls_bwd  # noqa: E402
from repro.kernels.ss_attention_bwd import query_side_bwd as j_qs_bwd  # noqa: E402
from repro_torch.core.attention import SSConfig  # noqa: E402
from repro_torch.kernels import build, launch_counts, ops  # noqa: E402
from repro_torch.kernels.ss_attention import b_side_mask, chunk_plan  # noqa: E402
from repro_torch.kernels.ss_attention_bwd import (QS_BWD_STEP_ROWS,  # noqa: E402
                                                  landmark_summary_bwd,
                                                  landmark_summary_bwd_plain,
                                                  query_side_bwd,
                                                  query_side_bwd_plain,
                                                  query_side_bwd_plan)

REL = 1e-5


@pytest.fixture
def one_cpu_thread():
    """Run the port's side of a comparison on one intra-op thread, so that
    neither the worker's thread count nor a load-dependent choice of
    OpenMP team size or MKL kernel enters its sums (the suite runs under
    pytest-xdist). Restores the thread count after the test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(port, ref, rel=REL):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    err, top = np.abs(port - ref).max(), np.abs(ref).max()
    assert err <= rel * top, f"max-abs err {err:.3e} > {rel} x {top:.3e}"


# --------------------------------------------------------------------------
# K3: landmark_summary_bwd
# --------------------------------------------------------------------------
K3_CASES = {
    # name: (n, c, block_n, kwargs) -- the forward cases of
    # test_torch_kernels.py
    "ragged_n": (500, 16, 128, {}),
    "kv_valid_in_last_block": (384, 16, 128, {"kv_valid": 333}),
    "segment_causal": (256, 16, 64, {"causal": True}),
    # rows 0 and 1 see no local key (l = 0): p stays 0, their dq_l is 0.
    # Only the reference's context-parallel path passes kv_offset, so this case
    # holds the plain version directly.
    "rows_fully_masked": (128, 16, 32, {"causal": True, "kv_offset": 40,
                                        "seq_len_k": 256}),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_landmark_summary_bwd_plain_matches_pallas(case, one_cpu_thread):
    n, c, block_n, kw = K3_CASES[case]
    rng = np.random.default_rng(11)
    q_l, k = _rand(rng, 3, c, 32, scale=0.5), _rand(rng, 3, n, 32, scale=0.5)
    v, g = _rand(rng, 3, n, 48), _rand(rng, 3, c, 48)
    scale = 32**-0.5
    jargs = [jnp.asarray(a) for a in (q_l, k, v)]
    bv, m, l = j_ls(*jargs, scale=scale, block_n=block_n, interpret=True,
                    return_stats=True, **kw)
    ref = j_ls_bwd(*jargs, bv, m, l, jnp.asarray(g), scale=scale,
                   block_n=block_n, interpret=True, **kw)
    t = [torch.from_numpy(np.array(a)) for a in (q_l, k, v, bv, m, l, g)]
    if "kv_offset" in kw:
        seg = -(-kw["seq_len_k"] // c)
        dcoef = torch.sum(t[6] * t[3], dim=-1, keepdim=True)
        out = landmark_summary_bwd_plain(t[0], t[1], t[2], t[6], t[4], t[5], dcoef,
                                         scale=scale, seg=seg, kv_offset=kw["kv_offset"])
    else:
        out = landmark_summary_bwd(*t, scale=scale, **kw)
    for o, r in zip(out, ref):
        _close(o, r)
    if case == "rows_fully_masked":
        assert torch.all(t[5][:, :2] == 0) and torch.all(out[0][:, :2] == 0)
    if "kv_valid" in kw:
        assert torch.all(out[1][:, kw["kv_valid"]:] == 0)
        assert torch.all(out[2][:, kw["kv_valid"]:] == 0)


def split_key_landmark_summary_bwd(q_l, k, v, g, m, l, dcoef, plan, scale):
    """Plain mirror of the bf16 K3 kernel's decomposition: each chunk
    rebuilds p and ds over its own keys and writes their dK, dV rows (keys
    past the chunks get zeros) and one dQ~ partial, summed in chunk order
    over the chunks each row reaches."""
    b, c, _ = q_l.shape
    n = k.shape[1]
    mask = b_side_mask(c, n, seg=plan.seg, kv_end=plan.n_end)
    dq, dk, dv = torch.zeros_like(q_l), torch.zeros_like(k), torch.zeros_like(v)
    reached = torch.tensor([plan.row_chunks(r) for r in range(c)])[:, None]
    for i in range(plan.chunks):
        lo, hi = plan.bounds(i)
        mk = mask[:, lo:hi]
        s = torch.einsum("bcd,bnd->bcn", q_l, k[:, lo:hi]) * scale
        p = torch.where(mk, torch.exp(s - m) / torch.clamp(l, min=1e-30), 0.0)
        ds = p * (torch.einsum("bce,bne->bcn", g, v[:, lo:hi]) - dcoef) * scale
        dv[:, lo:hi] = torch.einsum("bcn,bce->bne", p, g)
        dk[:, lo:hi] = torch.einsum("bcn,bcd->bnd", ds, q_l)
        part = torch.einsum("bcn,bnd->bcd", ds, k[:, lo:hi])
        dq = dq + torch.where(i < reached, part, 0.0)
    return dq, dk, dv


@pytest.mark.parametrize("case", ["c16_causal_n256", "kv_valid_333", "c32_causal_kv_valid",
                                  "kv_valid_zero"])
def test_split_key_backward_matches_plain(case):
    b, c, n, causal, kv_valid = {"c16_causal_n256": (3, 16, 256, True, None),
                                 "kv_valid_333": (3, 16, 384, False, 333),
                                 "c32_causal_kv_valid": (3, 32, 384, True, 333),
                                 "kv_valid_zero": (3, 16, 384, False, 0)}[case]
    rng = np.random.default_rng(16)
    q_l, k = _rand(rng, b, c, 32, scale=0.5), _rand(rng, b, n, 32, scale=0.5)
    v, g = _rand(rng, b, n, 48), _rand(rng, b, c, 48)
    t = [torch.from_numpy(a) for a in (q_l, k, v)]
    scale = 32**-0.5
    seg = -(-n // c) if causal else 0
    end = n if kv_valid is None else kv_valid
    bv, m, l = ops.landmark_summary(*t, scale=scale, causal=causal, kv_valid=kv_valid,
                                    return_stats=True)
    tg = torch.from_numpy(g)
    dcoef = torch.sum(tg * bv, dim=-1, keepdim=True)
    plan = chunk_plan(b, c, n, seg=seg, kv_end=end)
    assert plan.chunks > 1 or end == 0
    out = split_key_landmark_summary_bwd(*t, tg, m, l, dcoef, plan, scale)
    ref = landmark_summary_bwd_plain(*t, tg, m, l, dcoef, scale=scale, seg=seg, kv_end=end)
    for o, r in zip(out, ref):
        _close(o, r)
    assert torch.all(out[1][:, end:] == 0) and torch.all(out[2][:, end:] == 0)
    if end == 0:
        assert torch.all(out[0] == 0)


# --------------------------------------------------------------------------
# K4: query_side_bwd
# --------------------------------------------------------------------------
K4_CASES = {
    # name: (n, c, block_n, kwargs)
    "ragged_n": (500, 16, 128, {}),
    "causal_static_offset": (200, 16, 64, {"causal": True, "seq_len_k": 300}),
    "causal_q_offset": (160, 16, 64, {"causal": True, "seq_len_k": 512,
                                      "q_offset": 37}),
}


@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_query_side_bwd_plain_matches_pallas(case):
    n, c, block_n, kw = K4_CASES[case]
    rng = np.random.default_rng(12)
    q, k_l = _rand(rng, 2, n, 32, scale=0.5), _rand(rng, 2, c, 32, scale=0.5)
    m_mat, v, g = _rand(rng, 2, c, 24), _rand(rng, 2, n, 24), _rand(rng, 2, n, 24)
    delta = np.abs(_rand(rng, 2, 1, 1)) * 0.1
    scale = 32**-0.5
    arrays = (q, k_l, m_mat, v, delta, g)
    ref = j_qs_bwd(*(jnp.asarray(a) for a in arrays), scale=scale,
                   block_n=block_n, interpret=True, **kw)
    out = query_side_bwd(*(torch.from_numpy(a) for a in arrays), scale=scale, **kw)
    assert out[4].dtype == torch.float32 and out[4].shape == (2, 1, 1)
    for o, r in zip(out, ref):
        _close(o, r)


def runs_query_side_bwd(q, k_l, m_mat, v, delta, g, plan, *, scale, seg, pos_offset):
    """Plain mirror of the K4 kernels' decomposition: each run of the plan
    writes its rows' dQ and dV and one partial of dK~, dM and ddelta (its
    rows at their global positions under the F-mask), summed over the runs
    in order."""
    dq, dv = torch.zeros_like(q), torch.zeros_like(v)
    dkl, dm = torch.zeros_like(k_l), torch.zeros_like(m_mat)
    dd = torch.zeros_like(delta)
    for r in range(plan.runs):
        lo, hi = plan.rows(r)
        part = query_side_bwd_plain(q[:, lo:hi], k_l, m_mat, v[:, lo:hi], delta,
                                    g[:, lo:hi], scale=scale, seg=seg,
                                    pos_offset=pos_offset + lo)
        dq[:, lo:hi], dv[:, lo:hi] = part[0], part[3]
        dkl, dm, dd = dkl + part[1], dm + part[2], dd + part[4]
    return dq, dkl, dm, dv, dd


@pytest.mark.parametrize("case", ["bidir_ragged", "causal_q_offset", "causal_c16_one_run"])
def test_query_tile_runs_backward_match_plain(case):
    b, n, c, causal, q_offset = {"bidir_ragged": (2, 300, 32, False, None),
                                 "causal_q_offset": (2, 400, 16, True, 1000),
                                 "causal_c16_one_run": (3, 100, 16, True, None)}[case]
    rng = np.random.default_rng(17)
    q, k_l = _rand(rng, b, n, 32, scale=0.5), _rand(rng, b, c, 32, scale=0.5)
    m_mat, v, g = _rand(rng, b, c, 24), _rand(rng, b, n, 24), _rand(rng, b, n, 24)
    delta = np.abs(_rand(rng, b, 1, 1)) * 0.1
    t = [torch.from_numpy(a) for a in (q, k_l, m_mat, v, delta, g)]
    n_k = 2 * n if q_offset else n
    seg = -(-n_k // c) if causal else 0
    pos = (q_offset if q_offset is not None else n_k - n) if causal else 0
    plan = query_side_bwd_plan(b, n)
    assert plan.runs == -(-n // QS_BWD_STEP_ROWS)   # one step a run at these sizes
    out = runs_query_side_bwd(*t, plan, scale=32**-0.5, seg=seg, pos_offset=pos)
    ref = query_side_bwd(*t, scale=32**-0.5, causal=causal, seq_len_k=n_k,
                         q_offset=q_offset)
    for o, r in zip(out, ref):
        _close(o, r)


def test_backward_cpu_tensors_never_launch_a_kernel():
    before = launch_counts()
    rng = np.random.default_rng(13)
    t = [torch.from_numpy(_rand(rng, *s)) for s in
         ((1, 4, 8), (1, 9, 8), (1, 9, 8), (1, 4, 8), (1, 4, 1), (1, 4, 1), (1, 4, 8))]
    t[5] = t[5].abs() + 1
    landmark_summary_bwd(*t, scale=1.0)
    query_side_bwd(*(torch.from_numpy(_rand(rng, *s)) for s in
                     ((1, 9, 8), (1, 4, 8), (1, 4, 8), (1, 9, 8), (1, 1, 1), (1, 9, 8))),
                   scale=1.0)
    assert launch_counts() == before


def test_k4_step_rows_match_the_cuda_source():
    """The bf16 K4 kernel's 128-row step (two warpgroups of wgmma's 64 rows)
    is the step of the wrapper's query-tile plan."""
    src = (build.CSRC / "query_side_bwd.cu").read_text()
    assert re.search(r"kStepRows = 2 \* repro::kTileRows;", src)
    tile = int(re.search(r"kTileRows = (\d+);", (build.CSRC / "mma.cuh").read_text()).group(1))
    assert 2 * tile == QS_BWD_STEP_ROWS == 128


# --------------------------------------------------------------------------
# The autograd Functions (K1/K2 forward, K3/K4 backward) against jax.grad
# --------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("n,c", [(256, 32), (300, 16)], ids=["n_div_c", "padded_tail"])
def test_fused_attention_grads_match_jax(causal, n, c):
    rng = np.random.default_rng(14)
    q, k = _rand(rng, 2, n, 32, scale=0.5), _rand(rng, 2, n, 32, scale=0.5)
    v, w = _rand(rng, 2, n, 32), _rand(rng, 2, n, 32)
    jcfg = JSSConfig(num_landmarks=c, causal=causal)

    def jloss(q, k, v):
        return jnp.sum(jops.ss_attention_fused(q, k, v, jcfg, interpret=True) * w)

    jval = jloss(*(jnp.asarray(a) for a in (q, k, v)))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.ss_attention_fused(tq, tk, tv, SSConfig(num_landmarks=c, causal=causal))
    val = torch.sum(out * torch.from_numpy(w))
    grads = torch.autograd.grad(val, (tq, tk, tv))
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    # the Newton-Schulz core amplifies fp32 summation-order differences
    for name, gp, gr in zip("qkv", grads, jgrads):
        _close(gp, gr, rel=1e-4)


def test_functions_save_nothing_when_no_gradient_is_needed(monkeypatch):
    """Serving calls the kernels directly: no residuals, no K1 stats."""
    calls = []
    monkeypatch.setattr(ops, "landmark_summary_stats",
                        lambda *a: calls.append("k1") or ops.landmark_summary(
                            a[0], a[1], a[2], scale=a[3], causal=a[4], kv_valid=a[5],
                            return_stats=True))
    monkeypatch.setattr(ops, "query_side_differentiable",
                        lambda *a: calls.append("k2") or ops.query_side(
                            *a[:5], scale=a[5], causal=a[6], seq_len_k=a[7]))
    rng = np.random.default_rng(15)
    q = torch.from_numpy(_rand(rng, 2, 80, 16))
    cfg = SSConfig(num_landmarks=16, causal=True)
    with torch.no_grad():
        ops.ss_attention_fused(q, q, q, cfg)
    assert calls == []
    ops.ss_attention_fused(q.requires_grad_(True), q, q, cfg)
    assert calls == ["k1", "k2"]
