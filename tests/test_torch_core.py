"""The port's dense attention family and SPSD approximations
(``repro_torch.core``) against the JAX reference on the CPU.

Every function runs on the same numpy inputs (made from a seed) through
``repro.core`` (matmul precision "highest", ``tests/conftest.py``) and
``repro_torch.core`` in fp32:

* ``svd_pinv`` on SPSD inputs and on near-singular ones built with a
  spectral gap around ``rank_tol`` (singular values 8..1 and 1e-7: the
  cut-off cannot fall between the libraries' roundings);
* ``ss_core`` with ``method="svd"`` (by ``rank_tol`` and by
  ``target_rank``) and ``"iterative"``, shift on and off, on flat-tail
  (Lemma 1) matrices and on softmax cores;
* ``chunked_attention`` over the reference's (n, block) grid, causal or
  not, and a cross-length call; ``spectral_shift_attention`` in every
  regime of ``tests/test_core_attention.py`` (the <= c exact regime,
  explicit landmarks, ``eq10_literal``, ``delta_scale="corrected"``, the
  causal masks with U's lower-triangular projection, the ``+ delta V``
  term on trailing rows, svd and no-shift cores); ``nystrom_attention``
  and ``attention`` for every impl; random shapes through hypothesis
  (``tests/test_property.py``'s ``test_ss_attention_finite_any_shape``);
* ``sample_columns``, ``flat_tail_spsd`` and ``approximate_spsd`` in every
  model, and the paper's ordering (spectral-shift error <= Nystrom error)
  on flat-tail matrices through both packages.

Tolerances (max-abs difference over the reference's max-abs): one fp32
call is held to 1e-5 (``TOL``), SVD paths included (truncation cannot
flip across the gap; delta, a spectral value of A, is held relative to
max |A|). The iterative core's U and delta hold 5e-3 (``ITER_TOL``, up
to 3.1e-3 seen): delta is (tr A - tr AZA) / (c - tr AZ), both
differences of nearly equal traces, so fp32 rounding of the 6-step
Newton-Schulz Z (which itself agrees to 4e-7) shows in them a
thousandfold (ROADMAP Queue 3, P1 and P2); the same formulas run in
float64 through both packages agree to 1e-10. The attention calls hold
2e-5 (``SS_TOL``): their outputs mix U through F and B, and the largest
difference seen over the cases here is ~4e-6.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core import matrix_approx as jmatrix  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import matrix_approx  # noqa: E402

# the modules (each package's __init__ exports a function named attention)
jattn = importlib.import_module("repro.core.attention")
tattn = importlib.import_module("repro_torch.core.attention")

TOL = 1e-5
SS_TOL = 2e-5
ITER_TOL = 5e-3


def rel_err(out, ref) -> float:
    out = out.detach().double().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def qkv(seed: int, shape_q, shape_k=None, dv=None):
    rng = np.random.default_rng(seed)
    shape_k = shape_k or shape_q
    q = rng.normal(size=shape_q).astype(np.float32) * 0.5
    k = rng.normal(size=shape_k).astype(np.float32) * 0.5
    v = rng.normal(size=(*shape_k[:-1], dv or shape_k[-1])).astype(np.float32)
    return q, k, v


def both(fn_j, fn_t, *arrays, **kw):
    """Run ``fn_j`` on jnp arrays and ``fn_t`` on torch tensors."""
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    out_t = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    return out_j, out_t


def gapped_spsd(c: int, seed: int, tail: int = 0) -> np.ndarray:
    """SPSD c x c with singular values from 8 down to 1, then ``tail``
    values at 1e-7: a gap of seven decades around any rank_tol in
    [1e-6, 1e-2]."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(c, c)))
    lam = np.concatenate([np.linspace(8.0, 1.0, c - tail), np.full(tail, 1e-7)])
    return ((q * lam) @ q.T).astype(np.float32)


def softmax_core(c: int, seed: int, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, 8)).astype(np.float32) * scale
    s = x @ x.T / np.sqrt(8)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


# --------------------------------------------------------------------------
# pinv and the spectral-shift core
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tail,rank_tol", [(0, 1e-4), (3, 1e-4), (5, 1e-3), (2, 1e-6)])
def test_svd_pinv_matches_jax(tail, rank_tol):
    a = gapped_spsd(12, seed=tail, tail=tail)
    (zj, kj, sj), (zt, kt, st_) = both(jcore.svd_pinv, core.svd_pinv, a,
                                        rank_tol=rank_tol)
    assert np.array_equal(np.asarray(kj), kt.numpy())
    assert int(kt.sum()) == 12 - tail
    assert rel_err(st_, sj) < TOL
    assert rel_err(zt, zj) < TOL


def test_svd_pinv_batched_softmax_cores():
    a = np.stack([softmax_core(16, s) for s in range(3)])
    (zj, kj, _), (zt, kt, _) = both(jcore.svd_pinv, core.svd_pinv, a, rank_tol=1e-6)
    assert np.array_equal(np.asarray(kj), kt.numpy())
    assert rel_err(zt, zj) < TOL


CORE_CASES = {
    "svd_gapped": (lambda: gapped_spsd(16, 1, tail=4), dict(method="svd", rank_tol=1e-4)),
    "svd_flat_tail_target_rank": (
        lambda: np.array(jcore.flat_tail_spsd(24, 6, 0.3, seed=1)),
        dict(method="svd", target_rank=6)),
    "svd_no_shift": (lambda: gapped_spsd(16, 2, tail=3),
                     dict(method="svd", rank_tol=1e-4, use_shift=False)),
    "iterative_softmax": (lambda: softmax_core(16, 3), dict(method="iterative")),
    "iterative_softmax_wide": (lambda: softmax_core(32, 4, scale=1.5),
                               dict(method="iterative", pinv_iters=8)),
    "iterative_no_shift": (lambda: softmax_core(16, 5),
                           dict(method="iterative", use_shift=False)),
    "iterative_batched": (lambda: np.stack([softmax_core(16, s) for s in (6, 7)]),
                          dict(method="iterative")),
}


def core_errs(cj, ct, a) -> dict:
    """u and z relative to their own max-abs; delta, a spectral value of A,
    relative to max |A|."""
    return {"u": rel_err(ct.u, cj.u), "z": rel_err(ct.z, cj.z),
            "delta": float(np.abs(ct.delta.double().numpy() - np.asarray(cj.delta)).max()
                           / np.abs(a).max())}


@pytest.mark.parametrize("case", sorted(CORE_CASES))
def test_ss_core_matches_jax(case):
    """fp32. SVD cores and z at TOL. The iterative core's delta is
    (tr A - tr AZA) / (c - tr AZ): both terms are differences of nearly
    equal traces (P2), so fp32 rounding of Z shows in delta and U a
    thousandfold; they hold ITER_TOL here and the float64 test below holds
    the same formulas at 1e-10."""
    make, kw = CORE_CASES[case]
    a = make()
    cj, ct = both(jcore.ss_core, core.ss_core, a, **kw)
    errs = core_errs(cj, ct, a)
    bound = ITER_TOL if kw["method"] == "iterative" else TOL
    assert errs["z"] < TOL, errs
    assert errs["u"] < bound and errs["delta"] < bound, errs
    if not kw.get("use_shift", True):
        assert float(ct.delta.abs().max()) == 0.0


@pytest.mark.parametrize("case", sorted(c for c in CORE_CASES if "iterative" in c))
def test_ss_core_iterative_matches_jax_in_float64(case):
    import jax

    make, kw = CORE_CASES[case]
    a = make().astype(np.float64)
    with jax.enable_x64(True):
        cj = jcore.ss_core(jnp.asarray(a), **kw)
        assert cj.u.dtype == jnp.float64
        cj = jax.tree.map(np.asarray, cj)
    ct = core.ss_core(torch.from_numpy(a), **kw)
    assert ct.u.dtype == torch.float64
    errs = core_errs(cj, ct, a)
    assert max(errs.values()) < 1e-10, errs


def test_ss_core_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown ss_core method"):
        core.ss_core(torch.eye(4), method="qr")


# --------------------------------------------------------------------------
# chunked exact attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,block", [(256, 64), (250, 64), (100, 256)])
@pytest.mark.parametrize("causal", [False, True])
def test_chunked_attention_matches_jax(n, block, causal):
    q, k, v = qkv(n + block, (2, 3, n, 16))
    oj, ot = both(jattn.chunked_attention, tattn.chunked_attention, q, k, v,
                  causal=causal, block=block)
    assert rel_err(ot, oj) < TOL
    assert rel_err(ot, tattn.full_attention(*map(torch.from_numpy, (q, k, v)),
                                            causal=causal)) < TOL


def test_chunked_attention_cross_length():
    q, k, v = qkv(11, (2, 24, 16), (2, 200, 16), dv=8)
    oj, ot = both(jattn.chunked_attention, tattn.chunked_attention, q, k, v,
                  causal=True, block=64)
    assert ot.shape == (2, 24, 8)
    assert rel_err(ot, oj) < TOL


# --------------------------------------------------------------------------
# spectral shift and Nystrom
# --------------------------------------------------------------------------
SS_CASES = {
    "default": dict(n=256, cfg=dict(num_landmarks=32)),
    "exact_when_short": dict(n=24, cfg=dict(num_landmarks=32)),
    "causal": dict(n=200, cfg=dict(num_landmarks=16, causal=True)),
    "eq10_literal": dict(n=160, cfg=dict(num_landmarks=32, variant="eq10_literal")),
    "corrected": dict(n=256, cfg=dict(num_landmarks=32, delta_scale="corrected")),
    "causal_corrected": dict(n=256, cfg=dict(num_landmarks=16, causal=True,
                                             delta_scale="corrected")),
    "no_shift": dict(n=256, cfg=dict(num_landmarks=64, use_shift=False,
                                     include_shift_identity=False)),
    "no_identity_term": dict(n=192, cfg=dict(num_landmarks=32,
                                             include_shift_identity=False)),
    "svd": dict(n=256, cfg=dict(num_landmarks=32, method="svd")),
    "via_matmul_ragged": dict(n=250, cfg=dict(num_landmarks=32,
                                              landmark_via_matmul=True)),
}


@pytest.mark.parametrize("case", sorted(SS_CASES))
def test_spectral_shift_attention_matches_jax(case):
    spec = SS_CASES[case]
    q, k, v = qkv(len(case), (2, 2, spec["n"], 16))
    oj = jattn.spectral_shift_attention(*map(jnp.asarray, (q, k, v)),
                                        jattn.SSConfig(**spec["cfg"]))
    ot = tattn.spectral_shift_attention(*map(torch.from_numpy, (q, k, v)),
                                        tattn.SSConfig(**spec["cfg"]))
    assert ot.shape == oj.shape
    assert rel_err(ot, oj) < SS_TOL


def test_spectral_shift_explicit_landmarks_trailing_rows():
    """Decode convention: 4 queries at the tail of a 96-key context against
    cached landmarks; the + delta V term reads V's last 4 rows."""
    rng = np.random.default_rng(3)
    q, k, v = qkv(3, (2, 4, 16), (2, 96, 16))
    q_l = rng.normal(size=(2, 32, 16)).astype(np.float32) * 0.5
    k_l = rng.normal(size=(2, 32, 16)).astype(np.float32) * 0.5
    for causal in (False, True):
        kw = dict(num_landmarks=32, causal=causal)
        oj = jattn.spectral_shift_attention(
            *map(jnp.asarray, (q, k, v)), jattn.SSConfig(**kw),
            q_landmarks=jnp.asarray(q_l), k_landmarks=jnp.asarray(k_l))
        ot = tattn.spectral_shift_attention(
            *map(torch.from_numpy, (q, k, v)), tattn.SSConfig(**kw),
            q_landmarks=torch.from_numpy(q_l), k_landmarks=torch.from_numpy(k_l))
        assert rel_err(ot, oj) < SS_TOL, causal


def test_spectral_shift_rejects_mismatched_landmarks():
    q, k, v = qkv(0, (1, 8, 16), (1, 96, 16))
    with pytest.raises(ValueError, match="matching landmark counts"):
        tattn.spectral_shift_attention(*map(torch.from_numpy, (q, k, v)),
                                       tattn.SSConfig(num_landmarks=32))


def test_ss_factors_match_jax():
    q, k, _ = qkv(9, (2, 130, 16))
    for causal in (False, True):
        cfg = dict(num_landmarks=16, causal=causal)
        fj = jattn._ss_factors(jnp.asarray(q), jnp.asarray(k), jattn.SSConfig(**cfg), 0.25)
        ft = tattn._ss_factors(torch.from_numpy(q), torch.from_numpy(k),
                               tattn.SSConfig(**cfg), 0.25)
        for a, b in zip(ft, fj):
            assert rel_err(a, b) < TOL


@pytest.mark.parametrize("causal", [False, True])
def test_nystrom_attention_matches_jax(causal):
    q, k, v = qkv(21, (2, 2, 200, 16))
    oj, ot = both(jattn.nystrom_attention, tattn.nystrom_attention, q, k, v,
                  num_landmarks=32, causal=causal)
    assert rel_err(ot, oj) < SS_TOL


@pytest.mark.parametrize("impl", ["full", "chunked", "nystrom", "spectral_shift"])
def test_attention_dispatch_matches_jax(impl):
    q, k, v = qkv(5, (2, 2, 128, 16))
    oj = jattn.attention(*map(jnp.asarray, (q, k, v)), impl, causal=True,
                         ss_cfg=jattn.SSConfig(num_landmarks=16))
    ot = tattn.attention(*map(torch.from_numpy, (q, k, v)), impl, causal=True,
                         ss_cfg=tattn.SSConfig(num_landmarks=16))
    assert rel_err(ot, oj) < SS_TOL
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(*map(torch.from_numpy, (q, k, v)), "linformer")


def test_dtype_preserved():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in qkv(1, (1, 2, 128, 16)))
    for impl in ("full", "chunked", "nystrom", "spectral_shift"):
        assert tattn.attention(q, k, v, impl).dtype == torch.bfloat16


@settings(max_examples=6, deadline=None)
@given(n=st.integers(2, 300), c=st.sampled_from([4, 8, 16, 32]),
       seed=st.integers(0, 1000))
def test_ss_attention_any_shape_matches_jax(n, c, seed):
    q, k, v = qkv(seed, (1, n, 8))
    oj = jattn.spectral_shift_attention(*map(jnp.asarray, (q, k, v)),
                                        jattn.SSConfig(num_landmarks=c))
    ot = tattn.spectral_shift_attention(*map(torch.from_numpy, (q, k, v)),
                                        tattn.SSConfig(num_landmarks=c))
    assert bool(torch.isfinite(ot).all())
    assert rel_err(ot, oj) < SS_TOL


# --------------------------------------------------------------------------
# SPSD matrix approximation
# --------------------------------------------------------------------------
def test_sample_columns_and_flat_tail_match_jax():
    assert np.array_equal(matrix_approx.sample_columns(96, 12).numpy(),
                          np.asarray(jmatrix.sample_columns(96, 12)))
    kt = matrix_approx.flat_tail_spsd(48, 6, 0.2, seed=3)
    kj = jmatrix.flat_tail_spsd(48, 6, 0.2, seed=3)
    assert np.array_equal(kt.numpy(), np.asarray(kj))


@pytest.mark.parametrize("model,kw", [
    ("prototype", {}),
    ("modified_ss", dict(target_rank=8)),
    ("modified_ss", dict(rank_tol=1e-3)),
    ("modified_ss_shifted", dict(target_rank=8)),
])
def test_approximate_spsd_matches_jax(model, kw):
    kj = jmatrix.flat_tail_spsd(96, 8, 0.3, seed=0)
    cols = jmatrix.sample_columns(96, 16)
    aj = jmatrix.approximate_spsd(kj, cols, model, **kw)
    at = matrix_approx.approximate_spsd(torch.from_numpy(np.asarray(kj)),
                                        torch.from_numpy(np.asarray(cols)), model, **kw)
    assert rel_err(at, aj) < TOL


def test_approximate_spsd_rejects_unknown_model():
    with pytest.raises(ValueError, match="unknown approximation model"):
        matrix_approx.approximate_spsd(torch.eye(8), torch.arange(4), "cur")


@pytest.mark.parametrize("theta", [0.05, 0.3, 1.0])
def test_spectral_shift_beats_nystrom_on_flat_tails(theta):
    """Paper Theorem 1 through both packages: the shifted spectral-shift
    error is at most the Nystrom prototype's, and the two packages agree
    on both errors."""
    errs = {}
    for name, mod, wrap in (("jax", jmatrix, jnp.asarray),
                            ("torch", matrix_approx, torch.as_tensor)):
        k_mat = wrap(np.asarray(jmatrix.flat_tail_spsd(96, 8, theta, seed=3)))
        cols = wrap(np.asarray(jmatrix.sample_columns(96, 16)))
        ss = float(np.linalg.norm(np.asarray(k_mat - mod.approximate_spsd(
            k_mat, cols, "modified_ss_shifted", target_rank=8))))
        proto = float(np.linalg.norm(np.asarray(k_mat - mod.approximate_spsd(
            k_mat, cols, "prototype"))))
        assert ss <= proto + 1e-4, (name, ss, proto)
        errs[name] = (ss, proto)
    for a, b in zip(errs["torch"], errs["jax"]):
        assert abs(a - b) <= 1e-4 * max(b, 1.0)
