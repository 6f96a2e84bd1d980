"""The MLA shapes of the port's serving kernels against the JAX reference,
on the CPU.

DeepSeek-V2-Lite serves absorbed MLA: keys of kv_lora 512 + rope 64 = 576
columns, the 512-wide latents as values, 16 query heads on one latent
stream. What each CUDA wrapper runs for a CPU tensor -- the plain PyTorch
versions of K5 (``paged_row_stats_lanes`` with two key pools, the latent
pool also the value pool), K1 (``landmark_summary``) and K2
(``query_side``) -- is held against the Pallas kernels in interpret mode
on the same numpy inputs, in fp32: K5 at full dims (hkv 1, r 16, pools
512 + 64, dv 512, blocks of 16, kv_valid 0 / mid-block / every slot) and
at reduced dims, the two-pool split against one concatenated pool (the
reference's own contract, ``tests/test_kernels.py:568``), the refused
width mismatch; K1 with and without stats and with fp32 landmark means
over bf16 keys, and K2, at d = 576 and dv = 512 with a small b and n.
Tolerance: 1e-5 absolute and 1e-4 relative, as ``tests/test_torch_kernels.py``
holds the narrow shapes (the kernels stream keys in blocks with an online
softmax while the plain versions take one softmax, so sums are taken in
another order); bf16 keys against the reference's bf16 keys at 2e-5 of
max-abs (both round the same bf16 inputs; the sums are fp32). The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_decode import paged_row_stats_lanes as j_paged  # noqa: E402
from repro.kernels.ss_attention import landmark_summary as j_ls  # noqa: E402
from repro.kernels.ss_attention import query_side as j_qs  # noqa: E402
from repro_torch.kernels import HEAD_DIM_LIMITS, launch_counts  # noqa: E402
from repro_torch.kernels import paged_decode  # noqa: E402
from repro_torch.kernels.paged_decode import (paged_row_stats_lanes,  # noqa: E402
                                              paged_row_stats_plain)
from repro_torch.kernels.ss_attention import landmark_summary, query_side  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
LORA, ROPE, HEADS = 512, 64, 16
SCALE = (128 + 64) ** -0.5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               **(tol or TOL))


# --------------------------------------------------------------------------
# K5 with two key pools
# --------------------------------------------------------------------------
def _mla_pools(rng, lora, rope, r, kv_valid, bs=16, n_slots=3):
    """q (lanes, 1, r, lora + rope), latent and rope pools (1, nb, bs, .),
    a table of distinct blocks per lane (ZERO_BLOCK past each allocation)."""
    lanes = len(kv_valid)
    used = [max(-(-k // bs), 1) for k in kv_valid]
    nb = sum(used) + 2
    perm = rng.permutation(np.arange(1, nb))
    table = np.zeros((lanes, n_slots), np.int32)
    at = 0
    for ln, u in enumerate(used):
        table[ln, :u] = perm[at:at + u]
        at += u
    q = _rand(rng, lanes, 1, r, lora + rope, scale=0.3)
    lat = _rand(rng, 1, nb, bs, lora, scale=0.3)
    rp = _rand(rng, 1, nb, bs, rope, scale=0.3)
    return q, lat, rp, table, np.asarray(kv_valid, np.int32)


# kv_valid 0 (allocated, nothing valid), mid-block, every slot of 3
K5_CASES = {
    # name: (lora, rope, r)
    "full_dims": (LORA, ROPE, HEADS),
    "reduced_dims": (32, 16, 4),
}


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_two_pools_match_pallas(case):
    lora, rope, r = K5_CASES[case]
    bs, n_slots = 16, 3
    kv_valid = [0, 21, n_slots * bs]
    q, lat, rp, table, kvv = _mla_pools(np.random.default_rng(11), lora, rope, r,
                                        kv_valid, bs, n_slots)
    ref = j_paged(jnp.asarray(q), (jnp.asarray(lat), jnp.asarray(rp)), jnp.asarray(lat),
                  jnp.asarray(table), jnp.asarray(kvv), scale=SCALE, block_size=bs,
                  interpret=True)
    t_lat = torch.from_numpy(lat)
    args = (torch.from_numpy(q), (t_lat, torch.from_numpy(rp)), t_lat,
            torch.from_numpy(table), torch.from_numpy(kvv))
    out = paged_row_stats_lanes(*args, scale=SCALE, block_size=bs)
    for o, r_ in zip(out, ref):
        _close(o, r_)
    m, l, acc = out
    # the kv_valid = 0 lane: exactly the absorbing anchor
    assert torch.all(m[0] == -1e30) and torch.all(l[0] == 0) and torch.all(acc[0] == 0)
    assert acc.shape == (3, 1, r, lora)


def test_k5_split_pools_match_the_concatenated_pool():
    """Scores summed over the (latent, rope) pools equal one pool of the
    concatenated features, the value pool apart (the reference's contract,
    ``test_two_pool_split_matches_single``), bitwise in the plain version."""
    q, lat, rp, table, kvv = _mla_pools(np.random.default_rng(12), 32, 16, 4,
                                        [5, 16, 40])
    t = {k: torch.from_numpy(v) for k, v in dict(q=q, lat=lat, rp=rp, table=table,
                                                 kvv=kvv).items()}
    one = paged_row_stats_lanes(t["q"], (torch.cat([t["lat"], t["rp"]], -1),),
                                t["lat"].clone(), t["table"], t["kvv"], scale=0.3,
                                block_size=16)
    two = paged_row_stats_lanes(t["q"], (t["lat"], t["rp"]), t["lat"], t["table"],
                                t["kvv"], scale=0.3, block_size=16)
    ref = j_paged(jnp.asarray(q), (jnp.asarray(np.concatenate([lat, rp], -1)),),
                  jnp.asarray(lat), jnp.asarray(table), jnp.asarray(kvv), scale=0.3,
                  block_size=16, interpret=True)
    for o, w, r_ in zip(one, two, ref):
        _close(w, o, atol=1e-6, rtol=1e-6)
        _close(w, r_)


@pytest.mark.parametrize("widths", [(32,), (32, 8), (40, 16)],
                         ids=["one_short", "two_short", "two_long"])
def test_k5_width_mismatch_raises(widths):
    """Key-pool widths that do not sum to q's last dim (48) raise
    ``ValueError``, as the reference's wrapper does, on either side."""
    q, lat, rp, table, kvv = _mla_pools(np.random.default_rng(13), 32, 16, 4, [5, 16])
    pools = tuple(np.zeros((1, lat.shape[1], 16, w), np.float32) for w in widths)
    with pytest.raises(ValueError, match="sum"):
        j_paged(jnp.asarray(q), tuple(jnp.asarray(p) for p in pools), jnp.asarray(lat),
                jnp.asarray(table), jnp.asarray(kvv), scale=0.3, block_size=16,
                interpret=True)
    before = launch_counts()
    with pytest.raises(ValueError, match="sum"):
        paged_row_stats_lanes(torch.from_numpy(q), tuple(map(torch.from_numpy, pools)),
                              torch.from_numpy(lat), torch.from_numpy(table),
                              torch.from_numpy(kvv), scale=0.3, block_size=16)
    assert launch_counts() == before


@pytest.mark.parametrize("pools", [3, 0], ids=["three_pools", "no_pool"])
def test_k5_cuda_path_takes_one_or_two_key_pools(pools):
    """The launch path raises before any launch on a pool count the kernel
    does not take (its entry point has two key-pool slots)."""
    q = torch.zeros(2, 1, 4, 48)
    parts = [torch.zeros(1, 5, 16, 48 // pools)] * pools if pools else []
    before = launch_counts()
    with pytest.raises(ValueError):
        paged_decode._paged_row_stats_cuda(q, tuple(parts), torch.zeros(1, 5, 16, 16),
                                           torch.zeros(2, 2, dtype=torch.int32),
                                           torch.zeros(2, dtype=torch.int32), scale=0.5)
    assert launch_counts() == before


def test_k5_plain_version_handles_the_value_pool_as_a_key_pool():
    """With the latent pool as both a key pool and the value pool, the
    plain version equals a straightforward softmax over the gathered keys."""
    q, lat, rp, table, kvv = _mla_pools(np.random.default_rng(14), 32, 16, 4, [23])
    m, l, acc = paged_row_stats_plain(
        torch.from_numpy(q), (torch.from_numpy(lat), torch.from_numpy(rp)),
        torch.from_numpy(lat), torch.from_numpy(table), torch.from_numpy(kvv),
        scale=0.3)
    keys = np.concatenate([lat, rp], -1)[0][table[0]].reshape(-1, 48)[:23]
    s = q[0, 0] @ keys.T * 0.3
    p = np.exp(s - s.max(-1, keepdims=True))
    _close(acc[0, 0] / l[0, 0], (p / p.sum(-1, keepdims=True)) @ keys[:, :32])


# --------------------------------------------------------------------------
# K1 and K2 at d = 576, dv = 512
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["no_stats", "stats", "fp32_q_bf16_kv"])
def test_k1_wide_heads_match_pallas(kind):
    """K1 at MLA's prefill width: b = 2 batch-heads, c = 16, n = 40 with
    kv_valid 37 (a bucket-padded prompt), d = 576, dv = 512; the seed's
    fp32 landmark means over bf16 keys/values with stats."""
    rng = np.random.default_rng(15)
    b, c, n, d, dv = 2, 16, 40, LORA + ROPE, LORA
    q_l, k = _rand(rng, b, c, d, scale=0.3), _rand(rng, b, n, d, scale=0.3)
    v = _rand(rng, b, n, dv)
    stats = kind != "no_stats"
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if kind == "fp32_q_bf16_kv":
        tk, tv = tk.bfloat16(), tv.bfloat16()
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    ref = j_ls(jnp.asarray(q_l), jk, jv, scale=SCALE, block_n=16, interpret=True,
               return_stats=stats, kv_valid=37)
    out = landmark_summary(torch.from_numpy(q_l), tk, tv, scale=SCALE,
                           return_stats=stats, kv_valid=37)
    outs, refs = (out, ref) if stats else ((out,), (ref,))
    assert outs[0].shape == (b, c, dv)
    for o, r_ in zip(outs, refs):
        if o.dtype == torch.bfloat16:
            # both round the same fp32 sums to bf16: within one bf16 ulp
            _close(o.float(), np.asarray(r_, np.float32), atol=8e-3, rtol=8e-3)
        else:
            _close(o, r_)


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "segment_causal"])
def test_k2_wide_heads_match_pallas(causal):
    """K2 at MLA's prefill width: b = 2, n = 40, c = 16, d = 576, dv = 512,
    bidirectional (the prefill's) and with the segment-causal F-mask."""
    rng = np.random.default_rng(16)
    b, n, c, d, dv = 2, 40, 16, LORA + ROPE, LORA
    q, k_l = _rand(rng, b, n, d, scale=0.3), _rand(rng, b, c, d, scale=0.3)
    m_mat, v = _rand(rng, b, c, dv), _rand(rng, b, n, dv)
    delta = np.abs(_rand(rng, b, 1, 1, scale=0.1))
    ref = j_qs(*(jnp.asarray(a) for a in (q, k_l, m_mat, v, delta)), scale=SCALE,
               causal=causal, block_n=16, interpret=True)
    out = query_side(*(torch.from_numpy(a) for a in (q, k_l, m_mat, v, delta)),
                     scale=SCALE, causal=causal)
    assert out.shape == (b, n, dv)
    _close(out, ref)


def test_serving_kernels_take_mla_widths_training_kernels_do_not():
    """K1, K2 and K5 take absorbed MLA's (576, 512); K3 and K4, which no
    MLA path runs, stay at 128."""
    for name in ("landmark_summary", "query_side", "paged_row_stats"):
        assert HEAD_DIM_LIMITS[name] == (LORA + ROPE, LORA)
    for name in ("landmark_summary_bwd", "query_side_bwd"):
        assert HEAD_DIM_LIMITS[name] == (128, 128)
