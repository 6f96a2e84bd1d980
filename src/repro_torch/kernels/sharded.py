"""Context-parallel (sequence-sharded) spectral-shift attention
(``repro/kernels/sharded.py``): the single-device kernels on each rank's
slice of the sequence, with landmark-sized collectives between them.

Every cross-rank exchange has the size of a landmark, so attention stays
O(n / ranks) a rank:

    landmarks   Q~ / K~: one-hot segment sums over the rank's rows at their
                GLOBAL positions, one (c, 2d) all-reduce, divided by the
                true global segment counts;
    core        U_ss / delta: the replicated c x c ``ss_core_factors``,
                computed identically on every rank;
    B-side      BV = softmax(Q~ K^T) V: K1 over the rank's keys at its
                ``kv_offset`` with its online-softmax stats, then the flash
                merge: m* = max-all-reduce(m), (l, acc) re-anchored to m*
                (``ops.flash_rescale``) and sum-all-reduced, BV* = acc / l;
    F-side      out = softmax(Q K~^T) M + delta V: K2 on the rank's queries
                at their ``q_offset``, local.

Gradients. JAX gets the cross-shard sums of dQ~, dK~, dM and ddelta from
the transposes of its psums (``check_rep=False``). Torch transposes
nothing, so the accounting is explicit, in two differentiable ops and
nowhere else:

* ``repro_torch::seq_all_reduce`` (the landmark sums) all-reduces in its
  forward and all-reduces the cotangent in its backward: every rank's use
  of the replicated landmarks adds its partial, and the sum reaches each
  rank's own rows;
* ``repro_torch::landmark_summary_sp`` (the B-side) all-reduces the
  cotangent of BV* once, then runs K3 against the GLOBAL (BV*, m*, l*):
  dK, dV are complete for the rank's keys and dQ~ is the rank's partial,
  summed by the landmark op's backward.

The F-side's dK~, dM and ddelta stay the rank's partials for the same
reason. ``landmark_summary_sp`` is a custom op returning (BV*, m*, l*), so
``remat="ss_stats"`` keeps it as it keeps the single-device K1's op
(``models/model.py:_ss_stats_policy``).

Shapes: ``ss_attention_fused_sharded`` takes a rank's LOCAL rows. ``shard_sequence`` pads a
global (..., n, d) tensor to a multiple of the shard count (zeros, as the
reference) and takes the rank's slice; ``gather_sequence`` is its inverse
(differentiable). Ragged n: the padded tail never enters a softmax (K1's
global ``kv_valid``, the landmarks' validity mask) and its rows' outputs
are dropped by the caller. Cross attention (n_q != n_k) raises as in the
reference; one shard, or n <= c, takes the single-device route (n <= c on
the gathered sequence: exact attention). ``global_segment_means`` gives a
sharded sequence's segment means the same way (one all-reduce of the
one-hot sums): Whisper's cross attention takes its query landmarks from
it (``models/attention.py:cross_attention_forward``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.attention import SSConfig
from repro_torch.core.landmarks import onehot_segment_sums, segment_counts
from repro_torch.distributed.mesh import abstract_mesh, mesh_by_id
from repro_torch.kernels.ops import (flash_rescale, landmark_summary_bwd_op, query_side_op,
                                     ss_attention_fused, ss_core_factors)
from repro_torch.kernels.ss_attention import landmark_summary


def _axes(axes: str) -> tuple:
    return tuple(a for a in axes.split(",") if a)


# --------------------------------------------------------------------------
# The two collective ops.
# --------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::seq_all_reduce", mutates_args=())
def seq_all_reduce(x: torch.Tensor, mesh_id: int, axes: str) -> torch.Tensor:
    """Sum of x over the mesh axes ``axes`` (comma-joined); its backward
    sums the cotangent the same way."""
    return mesh_by_id(mesh_id).all_reduce(x, "sum", _axes(axes))


@seq_all_reduce.register_fake
def _(x, mesh_id, axes):
    mesh = abstract_mesh(mesh_id)
    return mesh.all_reduce(x, "sum", _axes(axes)) if mesh is not None else torch.empty_like(x)


def _seq_all_reduce_setup(ctx, inputs, output):
    ctx.meta = inputs[1:]


def _seq_all_reduce_backward(ctx, g):
    return seq_all_reduce(g.contiguous(), *ctx.meta), None, None


seq_all_reduce.register_autograd(_seq_all_reduce_backward,
                                 setup_context=_seq_all_reduce_setup)


@torch.library.custom_op("repro_torch::landmark_summary_sp", mutates_args=())
def landmark_summary_sp(q_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, causal: bool, seq_len: int, kv_offset: int,
                        chunk_keys: int, mesh_id: int,
                        axes: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The global B-side over sequence-sharded keys (``sharded.py:69``):
    K1 on this rank's keys (global positions ``kv_offset`` ...; ``seq_len``
    the true global length, which bounds the keys and sets the segment
    length) with its stats, then the flash merge across ``axes``. Returns
    (BV*, m*, l*), identical on every rank of the group."""
    return _landmark_summary_sp(q_l, k, v, scale, causal, seq_len, kv_offset, chunk_keys,
                                mesh_id, axes)


def _landmark_summary_sp(q_l, k, v, scale, causal, seq_len, kv_offset, chunk_keys,
                         mesh_id, axes):
    mesh, ax = mesh_by_id(mesh_id), _axes(axes)
    bv, m, l = landmark_summary(q_l, k, v, scale=scale, causal=causal, return_stats=True,
                                kv_valid=seq_len, seq_len_k=seq_len, kv_offset=kv_offset,
                                chunk_keys=chunk_keys)
    m_g = mesh.all_reduce(m, "max", ax)
    # bv is the locally normalised numerator (acc / l): acc = bv l
    l_r, acc_r = flash_rescale(m, l, bv.float() * l, m_g)
    la = mesh.all_reduce(torch.cat([l_r, acc_r], dim=-1), "sum", ax)
    l_g, acc_g = la[..., :1].contiguous(), la[..., 1:]
    return (acc_g / torch.clamp(l_g, min=1e-30)).to(v.dtype), m_g, l_g


@landmark_summary_sp.register_fake
def _(q_l, k, v, scale, causal, seq_len, kv_offset, chunk_keys, mesh_id, axes):
    if abstract_mesh(mesh_id) is not None:   # records the merge's collectives
        return _landmark_summary_sp(q_l, k, v, scale, causal, seq_len, kv_offset,
                                    chunk_keys, mesh_id, axes)
    b, c, _ = q_l.shape
    stat = q_l.new_empty((b, c, 1), dtype=torch.float32)
    return v.new_empty((b, c, v.shape[-1])), stat, torch.empty_like(stat)


def _landmark_summary_sp_setup(ctx, inputs, output):
    q_l, k, v, *meta = inputs
    bv, m, l = output
    ctx.save_for_backward(q_l, k, v, bv, m, l)
    ctx.meta = meta


def _landmark_summary_sp_backward(ctx, g, _gm, _gl):
    q_l, k, v, bv, m, l = ctx.saved_tensors
    scale, causal, seq_len, kv_offset, chunk_keys, mesh_id, axes = ctx.meta
    # BV* feeds every rank's own output rows: its cotangent is the sum of
    # the ranks' cotangents, reduced once here
    g = mesh_by_id(mesh_id).all_reduce(g.contiguous(), "sum", _axes(axes))
    dq, dk, dv = landmark_summary_bwd_op(q_l, k, v, bv, m, l, g, scale, causal, seq_len,
                                         seq_len, kv_offset, chunk_keys)
    return dq, dk, dv, None, None, None, None, None, None, None


landmark_summary_sp.register_autograd(_landmark_summary_sp_backward,
                                      setup_context=_landmark_summary_sp_setup)


# --------------------------------------------------------------------------
# Global <-> local rows.
# --------------------------------------------------------------------------
def local_length(n: int, shards: int) -> int:
    """Rows a rank holds of an n-token sequence split over ``shards``: the
    padded length's share, ceil(n / shards)."""
    return -(-n // shards)


def shard_sequence(x: torch.Tensor, mesh, seq_axes) -> torch.Tensor:
    """This rank's rows of a global (..., n, d) tensor: zero-padded to a
    multiple of the shard count (the reference's padding), then the rank's
    slice by its flat index over ``seq_axes``."""
    shards = mesh.axis_size(seq_axes)
    n = x.shape[-2]
    n_loc = local_length(n, shards)
    pad = n_loc * shards - n
    if pad:
        x = torch.cat([x, x.new_zeros((*x.shape[:-2], pad, x.shape[-1]))], dim=-2)
    i = mesh.index(seq_axes)
    return x[..., i * n_loc:(i + 1) * n_loc, :].contiguous()


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, seq_axes):
        ctx.meta = (mesh, seq_axes, x.shape[-2])
        return mesh.all_gather(x.contiguous(), seq_axes, dim=x.dim() - 2)

    @staticmethod
    def backward(ctx, g):
        mesh, seq_axes, n_loc = ctx.meta
        g = mesh.all_reduce(g.contiguous(), "sum", seq_axes)
        i = mesh.index(seq_axes)
        return g[..., i * n_loc:(i + 1) * n_loc, :].contiguous(), None, None


def gather_sequence(x: torch.Tensor, mesh, seq_axes, n: Optional[int] = None) -> torch.Tensor:
    """The global (..., n, d) tensor from every rank's rows (padding past n
    dropped); differentiable, each rank's gradient reaching its own rows."""
    out = _GatherSequence.apply(x, mesh, tuple(seq_axes))
    return out if n is None else out[..., :n, :]


# --------------------------------------------------------------------------
# Entry point.
# --------------------------------------------------------------------------
def _masked_landmarks(qf, kf, c: int, pos, valid, seg_lm: int, n: int, mesh, axes: str):
    """Global segment-mean landmarks Q~, K~ from a rank's rows
    (``sharded.py:176``): the shared ``onehot_segment_sums`` GEMM on global
    positions, one all-reduce of both sums, divided by the true global
    ``segment_counts``."""
    oh = (((pos // seg_lm)[None, :] == torch.arange(c, device=pos.device)[:, None])
          & valid[None, :])
    d = qf.shape[-1]
    sums = torch.cat([onehot_segment_sums(qf, oh), onehot_segment_sums(kf, oh)], dim=-1)
    sums = seq_all_reduce(sums.contiguous(), mesh.mesh_id, axes)
    counts = segment_counts(n, c, seg_lm, device=sums.device)[:, None]
    return ((sums[..., :d] / counts).to(qf.dtype), (sums[..., d:] / counts).to(kf.dtype))


def global_segment_means(x: torch.Tensor, num_landmarks: int, mesh, seq_axes) -> torch.Tensor:
    """``core/landmarks.py:segment_means`` of the whole sequence from a
    rank's rows ``x`` (..., n_loc, d) of a sequence of n_loc x shards
    tokens split over ``seq_axes``: one-hot segment sums over the rank's
    rows at their GLOBAL segment ids (segments of ceil(n / m) of the
    global n), summed over the shards (``seq_all_reduce``, whose backward
    sums the cotangent, so each rank's rows get every rank's use of the
    means), divided by the true global counts (the padded last segment's
    ``segment_counts``) and cast after the divide; the sums in fp32. n <=
    m: every token a landmark, the gathered x. The same on every rank."""
    seq_axes = tuple(seq_axes)
    n_loc, m = x.shape[-2], int(num_landmarks)
    n = n_loc * mesh.axis_size(seq_axes)
    if n <= m:
        return gather_sequence(x, mesh, seq_axes)
    seg = -(-n // m)
    pos = mesh.index(seq_axes) * n_loc + torch.arange(n_loc, device=x.device)
    onehot = (pos // seg)[None, :] == torch.arange(m, device=x.device)[:, None]
    sums = seq_all_reduce(onehot_segment_sums(x, onehot).contiguous(), mesh.mesh_id,
                          ",".join(seq_axes))
    if seg * m == n:
        return (sums / float(seg)).to(x.dtype)
    return (sums / segment_counts(n, m, seg, device=x.device)[:, None]).to(x.dtype)


def ss_attention_fused_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               cfg: SSConfig = SSConfig(), *, mesh, seq_axes,
                               lead_axes=(), scale: Optional[float] = None,
                               block_n: int = 0, seq_len: Optional[int] = None) -> torch.Tensor:
    """Sequence-sharded ``ss_attention_fused`` (``sharded.py:190``): same
    math, the kernels on each rank's rows, landmark-sized collectives.

    q, k, v are this rank's rows (..., n_loc, d) of a sequence of
    ``seq_len`` tokens (default n_loc x shards) split over the mesh axes
    ``seq_axes``: the rank with flat index i holds global positions
    [i n_loc, (i + 1) n_loc), positions past seq_len being padding
    (``shard_sequence``). Returns the rank's output rows (..., n_loc, dv);
    a padded row's output is not meaningful. ``lead_axes`` (the reference's
    sharding of the batch-heads) is taken and not read: a rank already
    holds only its own leading rows. ``block_n``: the kernels' tiling (0 =
    their own plans). Differentiable in q, k and v; segment-causal with
    ``cfg.causal``; self-attention only."""
    *lead, n_loc, d = q.shape
    n_k_loc, dv = k.shape[-2], v.shape[-1]
    c = cfg.num_landmarks
    seq_axes = tuple(seq_axes)
    shards = mesh.axis_size(seq_axes)
    if n_loc != n_k_loc:
        raise ValueError("sequence-sharded fused attention is self-attention only "
                         f"(n_q={n_loc} != n_k={n_k_loc} a rank)")
    n = n_loc * shards if seq_len is None else int(seq_len)
    if local_length(n, shards) != n_loc:
        raise ValueError(f"a sequence of {n} tokens over {shards} shards puts "
                         f"{local_length(n, shards)} rows on a rank, not {n_loc}")
    if shards <= 1:
        return ss_attention_fused(q, k, v, cfg, scale=scale, block_n=block_n)
    if n <= c:
        # the exact-attention regime: on the gathered (tiny) sequence
        qg, kg, vg = (gather_sequence(x, mesh, seq_axes, n) for x in (q, k, v))
        out = ss_attention_fused(qg, kg, vg, cfg, scale=scale, block_n=block_n)
        return shard_sequence(out, mesh, seq_axes)
    if q.is_cuda:
        from repro_torch.kernels.dispatch import check_tiling

        check_tiling(block_n, 0, backward=torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)))
    else:
        block_n = 0   # the plain versions ignore every tiling
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    b = math.prod(lead)
    qf = q.reshape(b, n_loc, d).contiguous()
    kf = k.reshape(b, n_loc, d).contiguous()
    vf = v.reshape(b, n_loc, dv).contiguous()
    axes = ",".join(seq_axes)
    off = mesh.index(seq_axes) * n_loc
    pos = off + torch.arange(n_loc, device=q.device)
    seg_lm = -(-n // c)   # landmark segment length, from the TRUE length
    q_l, k_l = _masked_landmarks(qf, kf, c, pos, pos < n, seg_lm, n, mesh, axes)

    # the replicated c x c core: the same program on every rank
    u, delta_core = ss_core_factors(q_l, k_l, cfg, scale, n)
    bv, _, _ = landmark_summary_sp(q_l.contiguous(), kf, vf, float(scale), bool(cfg.causal),
                                   n, off, int(block_n), mesh.mesh_id, axes)
    m_mat = (u.float() @ bv.float()).to(v.dtype)
    if cfg.include_shift_identity:
        delta = delta_core.float()
        v_q = vf
    else:
        delta = torch.zeros((b, 1, 1), dtype=torch.float32, device=q.device)
        v_q = torch.zeros_like(vf)
    out = query_side_op(qf, k_l.contiguous(), m_mat.contiguous(), v_q, delta.contiguous(),
                        scale=scale, causal=cfg.causal, seq_len_k=n, q_offset=off,
                        run_rows=block_n)
    return out.reshape(*lead, n_loc, dv)
