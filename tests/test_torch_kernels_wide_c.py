"""The port's kernels past 64 landmarks, against the JAX reference, on the CPU.

Every kernel of the reference takes any landmark count c; the port's CUDA
kernels take it too (K2 / K4 tile the landmark columns by 64, K3 leaves
per-row-tile partials of dK / dV, K1 / K3 walk ``row_block`` rows a CTA,
the reference's ``block_c``). On the CPU each wrapper runs its plain
version, so this file holds:

* K1-K4's plain versions against the Pallas kernels in interpret mode at
  c = 96 (a partial last tile of 64) and c = 128, on the same numpy inputs
  in fp32, at 1e-5 of each output's max-abs (the kernels sum over key or
  query blocks, the plain versions in one product);
* plain mirrors of the CUDA kernels' decompositions past 64 (K2's online
  softmax over column tiles, K4's stats pass and per-tile dQ partials, K3's
  per-row-tile dK / dV partials) against the plain versions, at the same
  bound;
* the served model (reduced Qwen2-7B at ``num_landmarks=128``, greedy
  tokens identical to the JAX engine on ``ss_fused`` + ``paged``) and one
  training step of reduced paper-bert at c = 128 against
  ``jax.jit(make_train_step)`` under ``test_torch_train.py``'s one-layer
  bounds;
* the dispatch registry's ``block_c`` against the reference's candidates,
  and the CUDA wrappers' checks before launch at bf16 c = 80 and 200 (the
  launch itself monkeypatched: there is no card here).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.attention import SSConfig as JSSConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ss_attention import landmark_summary as j_ls  # noqa: E402
from repro.kernels.ss_attention import query_side as j_qs  # noqa: E402
from repro.kernels.ss_attention_bwd import landmark_summary_bwd as j_ls_bwd  # noqa: E402
from repro.kernels.ss_attention_bwd import query_side_bwd as j_qs_bwd  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.train import train_step as jtrain_step  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.attention import SSConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import dispatch, launch_counts, ops  # noqa: E402
from repro_torch.kernels import ss_attention as sa  # noqa: E402
from repro_torch.kernels import ss_attention_bwd as sb  # noqa: E402
from repro_torch.kernels.ss_attention import (ROW_TILE, b_side_mask,  # noqa: E402
                                              landmark_summary, query_side,
                                              query_side_plain, query_side_probs)
from repro_torch.kernels.ss_attention_bwd import (landmark_summary_bwd,  # noqa: E402
                                                  landmark_summary_bwd_plain,
                                                  query_side_bwd,
                                                  query_side_bwd_plain)
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small shapes and many small ops: one intra-op thread per test worker
    keeps parallel workers from oversubscribing the cores."""
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
# K2 / K4 past 64 landmark columns
# --------------------------------------------------------------------------
# name: (b, n, c, kwargs). Static offset: the queries at the tail of
# seq_len_k; q_offset: a sequence shard's first query position; ragged: n
# not a multiple of 64.
F_CASES = {
    "c96_causal_static_offset_ragged": (2, 201, 96, {"causal": True, "seq_len_k": 300}),
    "c128_causal_q_offset": (2, 160, 128, {"causal": True, "seq_len_k": 512,
                                           "q_offset": 37}),
    "c128_bidir_ragged": (1, 131, 128, {}),
}


def _f_inputs(case):
    b, n, c, kw = F_CASES[case]
    rng = np.random.default_rng(31)
    arrays = (_rand(rng, b, n, 32, scale=0.5), _rand(rng, b, c, 32, scale=0.5),
              _rand(rng, b, c, 24), _rand(rng, b, n, 24),
              np.abs(_rand(rng, b, 1, 1)) * 0.1, _rand(rng, b, n, 24))
    return arrays, kw


def _f_geometry(n, c, kw):
    n_k = kw.get("seq_len_k") or n
    if not kw.get("causal"):
        return 0, 0
    return -(-n_k // c), (n_k - n if kw.get("q_offset") is None else kw["q_offset"])


@pytest.mark.parametrize("case", sorted(F_CASES))
def test_query_side_past_64_matches_pallas(case):
    arrays, kw = _f_inputs(case)
    scale = 32**-0.5
    ref = j_qs(*(jnp.asarray(a) for a in arrays[:5]), scale=scale, block_n=128,
               interpret=True, **kw)
    out = query_side(*(torch.from_numpy(a) for a in arrays[:5]), scale=scale, **kw)
    _close(out, ref)


@pytest.mark.parametrize("case", sorted(F_CASES))
def test_query_side_bwd_past_64_matches_pallas(case):
    arrays, kw = _f_inputs(case)
    scale = 32**-0.5
    ref = j_qs_bwd(*(jnp.asarray(a) for a in arrays), scale=scale, block_n=128,
                   interpret=True, **kw)
    out = query_side_bwd(*(torch.from_numpy(a) for a in arrays), scale=scale, **kw)
    for o, r in zip(out, ref):
        _close(o, r)


def column_tiled_query_side(q, k_l, m_mat, v, delta, *, scale, seg, pos_offset,
                            stats=False):
    """Plain mirror of K2's kernels past 64 columns (csrc/query_side_ct.cuh):
    a running max and sum per row over column tiles of ROW_TILE, the P M
    accumulator rescaled when the max moves, tiles wholly past the rows'
    F-mask reach skipped, the sum floored at 1e-30. With ``stats``, K4's
    first pass: each row's (m, l, D = g . (P M) / l), v holding g."""
    b, n, _ = q.shape
    c = k_l.shape[1]
    s_all = torch.einsum("bnd,bcd->bnc", q, k_l) * scale
    lim = (torch.clamp((pos_offset + torch.arange(n)) // seg + 1, max=c) if seg
           else torch.full((n,), c))
    m = torch.full((b, n, 1), -1e30)
    l = torch.zeros((b, n, 1))
    acc = torch.zeros((b, n, m_mat.shape[2]))
    for c0 in range(0, int(lim.max()), ROW_TILE):
        cols = torch.arange(c0, min(c, c0 + ROW_TILE))
        valid = cols[None, :] < lim[:, None]
        s = torch.where(valid, s_all[:, :, cols], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ m_mat[:, cols]
        m = m_new
    pm = acc / torch.clamp(l, min=1e-30)
    if stats:
        return m, l, torch.sum(v * pm, dim=-1, keepdim=True)
    return pm + delta * v


def two_pass_query_side_bwd(q, k_l, m_mat, v, delta, g, *, scale, seg, pos_offset):
    """Plain mirror of K4's kernels past 64 columns: the stats pass, then one
    slice per column tile rebuilding P from (m, l) and ds from D, each
    tile's dQ a partial summed in tile order over the tiles a row reaches,
    dK~ / dM rows of its own tile, dV and ddelta from tile 0."""
    n, c = q.shape[1], k_l.shape[1]
    m, l, dcoef = column_tiled_query_side(q, k_l, m_mat, g, delta, scale=scale, seg=seg,
                                          pos_offset=pos_offset, stats=True)
    lim = (torch.clamp((pos_offset + torch.arange(n)) // seg + 1, max=c) if seg
           else torch.full((n,), c))
    dq, dkl, dm = torch.zeros_like(q), torch.zeros_like(k_l), torch.zeros_like(m_mat)
    for c0 in range(0, c, ROW_TILE):
        cols = torch.arange(c0, min(c, c0 + ROW_TILE))
        valid = cols[None, :] < lim[:, None]
        s = torch.einsum("bnd,bcd->bnc", q, k_l[:, cols]) * scale
        p = torch.where(valid, torch.exp(s - m) / torch.clamp(l, min=1e-30), 0.0)
        ds = p * (g @ m_mat[:, cols].transpose(1, 2) - dcoef) * scale
        reached = (c0 < lim)[None, :, None]
        dq = dq + torch.where(reached, ds @ k_l[:, cols], 0.0)
        dkl[:, cols] = ds.transpose(1, 2) @ q
        dm[:, cols] = p.transpose(1, 2) @ g
    return dq, dkl, dm, delta * g, torch.sum(g * v, dim=(1, 2), keepdim=True)


@pytest.mark.parametrize("case", sorted(F_CASES))
def test_column_tiled_decompositions_match_plain(case):
    arrays, kw = _f_inputs(case)
    t = [torch.from_numpy(a) for a in arrays]
    seg, pos = _f_geometry(t[0].shape[1], t[1].shape[1], kw)
    geo = dict(scale=32**-0.5, seg=seg, pos_offset=pos)
    _close(column_tiled_query_side(*t[:5], **geo), query_side_plain(*t[:5], **geo))
    for o, r in zip(two_pass_query_side_bwd(*t, **geo), query_side_bwd_plain(*t, **geo)):
        _close(o, r)
    # the stats pass's D is rowsum(P o dP)
    _, _, dcoef = column_tiled_query_side(*t[:3], t[5], t[4], stats=True, **geo)
    p = query_side_probs(t[0], t[1], **geo)
    _close(dcoef, torch.sum(p * (t[5] @ t[2].transpose(1, 2)), -1, keepdim=True))


# --------------------------------------------------------------------------
# K1 / K3 past 64 landmark rows
# --------------------------------------------------------------------------
# name: (n, c, block_n, kwargs)
B_CASES = {
    "c96_ragged_n": (301, 96, 128, {}),
    "c128_kv_valid": (384, 128, 128, {"kv_valid": 333}),
    # a later shard: the low rows reach no key of it (l = 0)
    "c96_causal_kv_offset": (256, 96, 128, {"causal": True, "kv_offset": 300,
                                           "seq_len_k": 640}),
}


def _b_inputs(case):
    n, c, block_n, kw = B_CASES[case]
    rng = np.random.default_rng(41)
    return (_rand(rng, 2, c, 32, scale=0.5), _rand(rng, 2, n, 32, scale=0.5),
            _rand(rng, 2, n, 24), _rand(rng, 2, c, 24)), block_n, kw


@pytest.mark.parametrize("case", sorted(B_CASES))
def test_landmark_summary_bwd_past_64_matches_pallas(case):
    (q_l, k, v, g), block_n, kw = _b_inputs(case)
    scale = 32**-0.5
    jargs = [jnp.asarray(a) for a in (q_l, k, v)]
    bv, m, l = j_ls(*jargs, scale=scale, block_n=block_n, interpret=True,
                    return_stats=True, **kw)
    ref = j_ls_bwd(*jargs, bv, m, l, jnp.asarray(g), scale=scale, block_n=block_n,
                   interpret=True, **kw)
    t = [torch.from_numpy(np.array(a)) for a in (q_l, k, v, bv, m, l, g)]
    out = landmark_summary_bwd(*t, scale=scale, **kw)
    for o, r in zip(out, ref):
        _close(o, r)
    fwd = landmark_summary(*t[:3], scale=scale, return_stats=True, **kw)
    for o, r in zip(fwd, (bv, m, l)):
        _close(o, r)
    if "kv_valid" in kw:
        assert torch.all(out[1][:, kw["kv_valid"]:] == 0)
        assert torch.all(out[2][:, kw["kv_valid"]:] == 0)


def row_tiled_landmark_summary_bwd(q_l, k, v, g, m, l, dcoef, *, scale, seg,
                                   kv_offset, kv_end):
    """Plain mirror of K3's bf16 kernel past 64 rows: each row tile of
    ROW_TILE rows gives its rows' dQ~ and a partial of dK and dV over the
    keys its rows may attend; the partials are summed in row-tile order."""
    c, n = q_l.shape[1], k.shape[1]
    dq = torch.zeros_like(q_l)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r0 in range(0, c, ROW_TILE):
        rows = slice(r0, min(c, r0 + ROW_TILE))
        mask = b_side_mask(c, n, seg=seg, kv_offset=kv_offset, kv_end=kv_end)[rows]
        s = torch.einsum("bcd,bnd->bcn", q_l[:, rows], k) * scale
        p = torch.where(mask, torch.exp(s - m[:, rows]) /
                        torch.clamp(l[:, rows], min=1e-30), 0.0)
        ds = p * (g[:, rows] @ v.transpose(1, 2) - dcoef[:, rows]) * scale
        dq[:, rows] = ds @ k
        reach = mask.any(0)[None, :, None]
        dk = dk + torch.where(reach, ds.transpose(1, 2) @ q_l[:, rows], 0.0)
        dv = dv + torch.where(reach, p.transpose(1, 2) @ g[:, rows], 0.0)
    return dq, dk, dv


@pytest.mark.parametrize("case", sorted(B_CASES))
def test_row_tiled_backward_matches_plain(case):
    (q_l, k, v, g), _, kw = _b_inputs(case)
    t = [torch.from_numpy(a) for a in (q_l, k, v, g)]
    n, c = t[1].shape[1], t[0].shape[1]
    seg = -(-(kw.get("seq_len_k") or n) // c) if kw.get("causal") else 0
    off = kw.get("kv_offset", 0)
    end = off + n if "kv_valid" not in kw else kw["kv_valid"]
    scale = 32**-0.5
    bv, m, l = sa.landmark_summary_plain(t[0], t[1], t[2], scale=scale, seg=seg,
                                         kv_offset=off, kv_end=end, return_stats=True)
    dcoef = torch.sum(t[3] * bv, dim=-1, keepdim=True)
    geo = dict(scale=scale, seg=seg, kv_offset=off, kv_end=end)
    for o, r in zip(row_tiled_landmark_summary_bwd(*t[:4], m, l, dcoef, **geo),
                    landmark_summary_bwd_plain(*t[:4], m, l, dcoef, **geo)):
        _close(o, r)


def test_block_c_half_of_c_matches_the_reference():
    """K1 with the reference's block_c = c / 2 at c = 128, alone and inside
    ss_attention_fused (block_c reaches K1 / K3 as row_block); the whole
    attention at 1e-4, as ``test_torch_kernels_bwd.py``'s fused grads: the
    Newton-Schulz core amplifies fp32 summation-order differences."""
    rng = np.random.default_rng(43)
    q_l, k, v = _rand(rng, 2, 128, 32, scale=0.5), _rand(rng, 2, 200, 32, scale=0.5), \
        _rand(rng, 2, 200, 24)
    scale = 32**-0.5
    ref = j_ls(*(jnp.asarray(a) for a in (q_l, k, v)), scale=scale, block_n=128,
               block_c=64, interpret=True, causal=True, return_stats=True)
    out = landmark_summary(*(torch.from_numpy(a) for a in (q_l, k, v)), scale=scale,
                           causal=True, return_stats=True, row_block=64)
    for o, r in zip(out, ref):
        _close(o, r)
    x = _rand(rng, 1, 2, 200, 32, scale=0.5)
    ref = jops.ss_attention_fused(*([jnp.asarray(x)] * 3),
                                  JSSConfig(num_landmarks=128, causal=True),
                                  block_n=128, block_c=64, interpret=True)
    out = ops.ss_attention_fused(*([torch.from_numpy(x)] * 3),
                                 SSConfig(num_landmarks=128, causal=True), block_c=64)
    _close(out, ref, rel=1e-4)


# --------------------------------------------------------------------------
# The dispatch registry's block_c
# --------------------------------------------------------------------------
@pytest.mark.parametrize("c", [64, 128, 256])
def test_block_c_candidates_match_the_reference(c):
    """The reference sweeps block_c in {0, c/2, c/4} (whole, >= 8;
    ``repro/kernels/dispatch.py:379``); the CUDA kernels take 0 and the
    multiples of ROW_TILE that divide c, and a bf16 CUDA key's sweep times
    exactly those."""
    ref = (0,) + tuple(c // f for f in (2, 4) if c % f == 0 and c // f >= 8)
    assert dispatch.reference_block_c(c) == ref
    taken = tuple(bc for bc in ref if bc % ROW_TILE == 0)
    for bc in ref:
        if bc in taken:
            dispatch.check_tiling(0, bc, c=c, backward=True)
        else:
            with pytest.raises(ValueError, match="block_c"):
                dispatch.check_tiling(0, bc, c=c, backward=True)
    for bad in (96, 2 * c, -64):
        with pytest.raises(ValueError, match="block_c"):
            dispatch.check_tiling(0, bad, c=c)
    key = dispatch.make_key(4096, c, 64, torch.bfloat16, True, backend="cuda")
    cands = dispatch._block_n_candidates(key, (256, 512), ref)
    assert cands[0] == (0, 0)
    assert {bc for _, bc in cands} == set(taken)
    assert {bn for bn, _ in cands} == {0, 256, 512}
    cpu = dispatch.make_key(4096, c, 64, torch.bfloat16, True, backend="cpu")
    assert dispatch._block_n_candidates(cpu, (256, 512), ref) == [(0, 0)]


# --------------------------------------------------------------------------
# The CUDA wrappers' checks before launch
# --------------------------------------------------------------------------
@pytest.mark.parametrize("c", [80, 200])
def test_wrappers_reach_launch_past_64_landmarks(c, monkeypatch):
    """bf16 K1-K4 at c = 80 and 200 pass every check before launch and
    hand the kernels their tiling: K1 / K3 a row_block, K3 its dK / dV
    partials' workspace, K4 its stats and dQ partials' workspaces (the
    launch recorded instead of run, and counted by no wrapper)."""
    calls = {}

    def fake_launch(name, *args):
        calls[name] = args

    for mod in (sa, sb):
        monkeypatch.setattr(mod, "launch", fake_launch)
        monkeypatch.setattr(mod, "_stream_handle", lambda t: 0)
    for fn in (sa.landmark_summary, sa.query_side, sb.landmark_summary_bwd,
               sb.query_side_bwd):   # each wrapper counts the launch it reached
        monkeypatch.setattr(fn, "launches", 0)
    b, n, d = 2, 300, 32
    bf = dict(dtype=torch.bfloat16)
    q, k, v = torch.zeros(b, n, d, **bf), torch.zeros(b, n, d, **bf), torch.zeros(b, n, d, **bf)
    q_l, k_l, m_mat = torch.zeros(b, c, d, **bf), torch.zeros(b, c, d, **bf), \
        torch.zeros(b, c, d, **bf)
    delta = torch.ones(b, 1, 1)
    f32 = torch.zeros(b, c, 1)
    before = launch_counts()   # 0 each: the counters are patched for the test
    sa._query_side_cuda(q, k_l, m_mat, v, delta, scale=0.25, seg=0, pos_offset=0)
    sb._query_side_bwd_cuda(q, k_l, m_mat, v, delta, q, scale=0.25, seg=3,
                            pos_offset=0)
    sa._landmark_summary_cuda(q_l, k, v, scale=0.25, seg=3, kv_end=n,
                              return_stats=True, row_block=128)
    sb._landmark_summary_bwd_cuda(q_l, k, v, q_l, f32, f32, f32, scale=0.25, seg=3,
                                  kv_end=n)
    assert set(calls) == {"query_side", "query_side_bwd", "landmark_summary",
                          "landmark_summary_bwd"}
    # K2: (..., b, n, c, d, dv, scale, seg, pos_offset, run_rows, dtype, stream)
    assert calls["query_side"][6:9] == (b, n, c)
    # K4: stats and ws_dq past 64 columns
    k4 = calls["query_side_bwd"]
    assert k4[14] is not None and k4[15] is not None and k4[16:19] == (b, n, c)
    # K1: (..., chunk_keys, row_block, q_dtype, kv_dtype, stream)
    assert calls["landmark_summary"][-4] == 128
    k3 = calls["landmark_summary_bwd"]
    assert k3[11] is not None and k3[-4] == ROW_TILE and k3[12:14] == (b, c)
    counts = launch_counts()
    assert [counts[name] - before[name] for name in calls] == [1, 1, 1, 1]
    before = launch_counts()
    with pytest.raises(ValueError, match="row_block"):
        sa._landmark_summary_cuda(q_l, k, v, scale=0.25, seg=0, kv_end=n,
                                  return_stats=False, row_block=32)
    assert launch_counts() == before


# --------------------------------------------------------------------------
# The served and trained model at c = 128
# --------------------------------------------------------------------------
SERVE_LENS = (40, 200)   # <= c (full attention, as the reference), > c


def test_qwen2_served_at_128_landmarks_matches_jax_engine():
    """Greedy tokens of reduced Qwen2-7B at num_landmarks=128, served
    ss_fused + paged, identical to the JAX engine's (the 40-token prompt
    takes the n <= c route, the 200-token one K1 / K2 past 64)."""
    serve = dict(max_lanes=2, max_seq=256, block_size=16, prefill_impl="ss_fused",
                 decode_impl="paged")
    jcfg = jbase.reduced(jget_config("qwen2-7b"), num_landmarks=128, num_layers=1)
    cfg = base.reduced(get_config("qwen2-7b"), num_landmarks=128, num_layers=1)
    jparams = jinit_params(jmodel.model_specs(jcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(5)
    prompts = [(uid, rng.integers(3, cfg.vocab_size, size=n).tolist())
               for uid, n in enumerate(SERVE_LENS)]
    outs = []
    for eng, req in ((JServeEngine(jcfg, jparams, serve=jbase.ServeConfig(**serve)),
                      JRequest),
                     (ServeEngine(cfg, params, serve=base.ServeConfig(**serve),
                                  device="cpu"), Request)):
        for uid, prompt in prompts:
            eng.submit(req(uid, list(prompt), max_new_tokens=6))
        outs.append(eng.run())
    assert outs[0] == outs[1]
    assert all(len(toks) == 6 for toks in outs[1].values())


def test_paper_bert_train_step_at_128_landmarks_matches_jax():
    """One training step of reduced paper-bert (one layer, c = 128, seq 256
    > c) under spectral_shift_fused against ``jax.jit(make_train_step)`` of
    the reference in interpret mode: loss, grad norm and parameters under
    ``test_torch_train.py``'s one-layer bounds."""
    loss_tol, gn_tol, _, p_tol, lr_tol = 1e-5, 1e-4, 1e-4, 1e-4, 1e-2
    seq, batch = 256, 2
    kw = dict(num_layers=1, num_landmarks=128, attention_impl="spectral_shift_fused")
    jcfg = jbase.reduced(jget_config("paper-bert"), attention_backend="interpret", **kw)
    cfg = base.reduced(get_config("paper-bert"), **kw)
    tcfg = dict(warmup_steps=2, total_steps=10)
    jt = jbase.TrainConfig(**tcfg)
    jparams = jinit_params(jmodel.model_specs(jcfg), jax.random.PRNGKey(0))
    jbatch = jpipeline.SyntheticLM(jcfg.vocab_size, seq, batch, seed=0).batch(0)
    lr_fn = jschedules.warmup_cosine(jt.learning_rate, jt.warmup_steps, jt.total_steps)
    jp, _, jm = jax.jit(jtrain_step.make_train_step(jcfg, jt, lr_fn))(
        jparams, jadamw.adamw_init(jparams), {"tokens": jnp.asarray(jbatch["tokens"])})
    t = base.TrainConfig(**tcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    step = make_train_step(cfg, t, schedules.warmup_cosine(t.learning_rate,
                                                           t.warmup_steps,
                                                           t.total_steps))
    data = pipeline.SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    params, _, m = step(params, adamw.adamw_init(params),
                        pipeline.to_device(data.batch(0), "cpu"))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= loss_tol * abs(float(jm["loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= gn_tol * float(
        jm["grad_norm"])
    lr = float(jm["lr"])
    for port, ref in zip(tree_leaves(params), jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        port = port.numpy()
        assert np.abs(port - ref).max() <= p_tol * np.abs(ref).max() + lr_tol * lr
