"""Spectral-shifting attention backed by the kernels.

``ss_attention_fused(q, k, v, cfg)`` mirrors ``repro/kernels/ops.py:230``:

    1. landmarks            segment means (masked under ``kv_valid``)
    2. A_s, U_ss, delta     the c x c core, ``ss_core_factors``
    3. BV                   K1 ``landmark_summary``, streamed over n
    4. M = U_ss @ BV        a (c x c) @ (c x dv) product
    5. out = F @ M + d * V  K2 ``query_side``, streamed over n

plus the online-softmax partial-state algebra (``flash_rescale`` /
``flash_merge``) that decode uses to merge the current token into the
kernels' partials.

``block_n`` (a dispatch plan's tiling, ``kernels/dispatch.py``) reaches
K1 / K3 as ``chunk_keys`` and K2 / K4 as ``run_rows``, ``block_c`` K1 / K3
as ``row_block``; 0 leaves K1 / K2 to
the serving tiling in effect (``dispatch.use_tiling``) and every kernel
otherwise to its own plan. ``nystrom_attention_fused`` is the same with delta = 0
(``ops.py:341``).

Steps 3 and 5 are differentiable: the custom ops
``repro_torch::landmark_summary`` and ``repro_torch::query_side`` (the
reference's custom-VJP ``landmark_summary_op`` / ``query_side_op``,
``ops.py:91-160``) run K1 / K2 forward and K3 / K4 backward. K1's
forward then also returns the fp32 (m, l) stats K3 rebuilds P from. The
landmark means and the c x c core stay on plain autograd, as they stay
on jnp autodiff in the reference. When nothing needs a gradient
(serving, ``torch.no_grad``), the kernels are called directly: no
residuals are saved and K1 computes no stats. K3 and K4 are custom ops
too (``repro_torch::landmark_summary_bwd`` / ``::query_side_bwd``), the
ops' backward, so that a FLOP count over a step (``kernels/cost.py``)
sees all four kernels on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.attention import SSConfig, _softmax, full_attention
from repro_torch.core.landmarks import masked_segment_means, segment_means
from repro_torch.core.spectral_shift import ss_core
from repro_torch.kernels.ss_attention import landmark_summary, query_side
from repro_torch.kernels.ss_attention_bwd import landmark_summary_bwd, query_side_bwd


# --------------------------------------------------------------------------
# Online-softmax partial-state algebra. A partial (m, l, acc) stands for
# sum_j exp(s_j - m) (l) and sum_j exp(s_j - m) v_j (acc); any finite anchor
# m gives the same acc / l.
# --------------------------------------------------------------------------
def flash_rescale(m, l, acc, m_new):
    """Re-anchor a partial state to ``m_new`` (>= m). Returns (l, acc)."""
    corr = torch.exp(m - m_new)
    return l * corr, acc * corr


def flash_merge(m_a, l_a, acc_a, m_b, l_b, acc_b):
    """Merge two partial states (``ops.py:77``); m/l carry a trailing
    singleton axis so they broadcast against acc (..., rows, dv)."""
    m = torch.maximum(m_a, m_b)
    l_ar, acc_ar = flash_rescale(m_a, l_a, acc_a, m)
    l_br, acc_br = flash_rescale(m_b, l_b, acc_b, m)
    return m, l_ar + l_br, acc_ar + acc_br


# --------------------------------------------------------------------------
# Differentiable kernel ops. K1 and K2 are registered as torch.library
# custom ops, so a selective-checkpoint policy (models/model.py) sees them
# as ops it can save or recompute: a ctypes launch inside a plain
# autograd.Function is invisible to the dispatcher. Each op's
# implementation is its wrapper (the kernel for CUDA tensors, the plain
# version for CPU ones); its backward is K3 / K4.
# --------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::landmark_summary", mutates_args=())
def landmark_summary_stats(q_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, causal: bool,
                           kv_valid: Optional[int], chunk_keys: int = 0,
                           row_block: int = 0) -> tuple[torch.Tensor, torch.Tensor,
                                                        torch.Tensor]:
    """K1 with its fp32 stats (``landmark_summary_op`` :91): (BV, m, l). Its
    outputs are the residuals the reference tags ``ss_bv`` / ``ss_stats``
    (``ops.py:112``), the ones ``remat="ss_stats"`` keeps."""
    return landmark_summary(q_l, k, v, scale=scale, causal=causal,
                            return_stats=True, kv_valid=kv_valid,
                            chunk_keys=chunk_keys, row_block=row_block)


@landmark_summary_stats.register_fake
def _(q_l, k, v, scale, causal, kv_valid, chunk_keys=0, row_block=0):
    b, c, _ = q_l.shape
    stat = q_l.new_empty((b, c, 1), dtype=torch.float32)
    return v.new_empty((b, c, v.shape[-1])), stat, torch.empty_like(stat)


def _landmark_summary_setup(ctx, inputs, output):
    q_l, k, v, scale, causal, kv_valid, chunk_keys, row_block = inputs
    bv, m, l = output
    ctx.save_for_backward(q_l, k, v, bv, m, l)
    ctx.meta = (scale, causal, kv_valid, chunk_keys, row_block)


def _landmark_summary_backward(ctx, g, _gm, _gl):
    q_l, k, v, bv, m, l = ctx.saved_tensors
    scale, causal, kv_valid, chunk_keys, row_block = ctx.meta
    dq, dk, dv = landmark_summary_bwd_op(q_l, k, v, bv, m, l, g.contiguous(), scale,
                                         causal, kv_valid, 0, 0, chunk_keys, row_block)
    return dq, dk, dv, None, None, None, None, None


@torch.library.custom_op("repro_torch::landmark_summary_bwd", mutates_args=())
def landmark_summary_bwd_op(q_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bv: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                            g: torch.Tensor, scale: float, causal: bool,
                            kv_valid: Optional[int], seq_len_k: int, kv_offset: int,
                            chunk_keys: int, row_block: int = 0,
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 as an op of its own (the backward of the K1 ops), so a FLOP
    count over a step sees it (``kernels/cost.py``) on every device."""
    return landmark_summary_bwd(q_l, k, v, bv, m, l, g, scale=scale, causal=causal,
                                kv_valid=kv_valid, seq_len_k=seq_len_k,
                                kv_offset=kv_offset, chunk_keys=chunk_keys,
                                row_block=row_block)


@landmark_summary_bwd_op.register_fake
def _(q_l, k, v, bv, m, l, g, scale, causal, kv_valid, seq_len_k, kv_offset, chunk_keys,
      row_block=0):
    return torch.empty_like(q_l), torch.empty_like(k), torch.empty_like(v)


landmark_summary_stats.register_autograd(_landmark_summary_backward,
                                         setup_context=_landmark_summary_setup)


@torch.library.custom_op("repro_torch::query_side", mutates_args=())
def query_side_differentiable(q: torch.Tensor, k_l: torch.Tensor, m_mat: torch.Tensor,
                              v: torch.Tensor, delta: torch.Tensor, scale: float,
                              causal: bool, seq_len_k: int,
                              run_rows: int = 0,
                              q_offset: Optional[int] = None) -> torch.Tensor:
    """K2 (``query_side_op`` :135); K4 recomputes P in its backward, so the
    residuals are the inputs. ``q_offset``: the queries' first global
    position (a sequence shard's offset; None = the tail of seq_len_k)."""
    return query_side(q, k_l, m_mat, v, delta, scale=scale, causal=causal,
                      seq_len_k=seq_len_k, q_offset=q_offset, run_rows=run_rows)


@query_side_differentiable.register_fake
def _(q, k_l, m_mat, v, delta, scale, causal, seq_len_k, run_rows=0, q_offset=None):
    return q.new_empty((*q.shape[:2], v.shape[-1]))


def _query_side_setup(ctx, inputs, output):
    q, k_l, m_mat, v, delta, scale, causal, seq_len_k, run_rows, q_offset = inputs
    ctx.save_for_backward(q, k_l, m_mat, v, delta)
    ctx.meta = (scale, causal, seq_len_k, run_rows, q_offset)


def _query_side_backward(ctx, g):
    q, k_l, m_mat, v, delta = ctx.saved_tensors
    scale, causal, seq_len_k, run_rows, q_offset = ctx.meta
    dq, dkl, dm, dv, dd = query_side_bwd_op(q, k_l, m_mat, v, delta, g.contiguous(), scale,
                                            causal, seq_len_k, q_offset, run_rows)
    return dq, dkl, dm, dv, dd, None, None, None, None, None


@torch.library.custom_op("repro_torch::query_side_bwd", mutates_args=())
def query_side_bwd_op(q: torch.Tensor, k_l: torch.Tensor, m_mat: torch.Tensor,
                      v: torch.Tensor, delta: torch.Tensor, g: torch.Tensor, scale: float,
                      causal: bool, seq_len_k: int, q_offset: Optional[int],
                      run_rows: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                              torch.Tensor, torch.Tensor]:
    """K4 as an op of its own (the backward of the K2 op), counted as K3's."""
    return query_side_bwd(q, k_l, m_mat, v, delta, g, scale=scale, causal=causal,
                          seq_len_k=seq_len_k, q_offset=q_offset, run_rows=run_rows)


@query_side_bwd_op.register_fake
def _(q, k_l, m_mat, v, delta, g, scale, causal, seq_len_k, q_offset, run_rows):
    return (torch.empty_like(q), torch.empty_like(k_l), torch.empty_like(m_mat),
            torch.empty_like(v), delta.new_empty((q.shape[0], 1, 1), dtype=torch.float32))


query_side_differentiable.register_autograd(_query_side_backward,
                                            setup_context=_query_side_setup)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _through_op(*tensors) -> bool:
    """Whether K1 / K2 go through their custom ops: when a gradient is
    needed, and on the meta device (the dry-run), where the ops' fakes
    stand in and a FLOP count sees the kernels' formulas."""
    return _needs_grad(*tensors) or tensors[0].is_meta


def landmark_summary_op(q_l, k, v, *, scale: float, causal: bool = False,
                        kv_valid: Optional[int] = None, chunk_keys: int = 0,
                        row_block: int = 0) -> torch.Tensor:
    """K1 as a differentiable op: through the ``repro_torch::landmark_summary``
    custom op when a gradient is needed, else the kernel alone (no stats,
    nothing saved). ``chunk_keys`` and ``row_block`` reach K1 and K3."""
    if _through_op(q_l, k, v):
        return landmark_summary_stats(q_l, k, v, float(scale), bool(causal),
                                      None if kv_valid is None else int(kv_valid),
                                      int(chunk_keys), int(row_block))[0]
    return landmark_summary(q_l, k, v, scale=scale, causal=causal,
                            kv_valid=kv_valid, chunk_keys=chunk_keys,
                            row_block=row_block)


def query_side_op(q, k_l, m_mat, v, delta, *, scale: float,
                  causal: bool = False, seq_len_k: int = 0,
                  run_rows: int = 0, q_offset: Optional[int] = None) -> torch.Tensor:
    """K2 as a differentiable op (the ``repro_torch::query_side`` custom op
    when a gradient is needed, else the kernel alone). ``run_rows`` reaches
    K2 and K4, ``q_offset`` (a sequence shard's first query position) both."""
    q_offset = None if q_offset is None else int(q_offset)
    if _through_op(q, k_l, m_mat, v, delta):
        return query_side_differentiable(q, k_l, m_mat, v, delta, float(scale),
                                         bool(causal), int(seq_len_k), int(run_rows),
                                         q_offset)
    return query_side(q, k_l, m_mat, v, delta, scale=scale, causal=causal,
                      seq_len_k=seq_len_k, q_offset=q_offset, run_rows=run_rows)


# --------------------------------------------------------------------------
# The c x c spectral-shift core.
# --------------------------------------------------------------------------
def ss_core_factors(q_l, k_l, cfg: SSConfig, scale: float, n_k):
    """fp32 (U, delta) of the c x c core (``ops.py:166``): fp32 softmax of
    the landmark scores (causally masked for ``cfg.causal``), Newton-Schulz
    pinv and shift, the ``delta_scale="corrected"`` rescale by c / n_k (the
    TRUE key length), the ``eq10_literal`` variant and the causal
    lower-triangular projection of U."""
    c = q_l.shape[-2]
    dev = q_l.device
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    a = _softmax(torch.einsum("...cd,...ed->...ce", q_l.float(), k_l.float())
                 * scale, tril if cfg.causal else None)
    core = ss_core(a, method=cfg.method, pinv_iters=cfg.pinv_iters,
                   rank_tol=cfg.rank_tol, use_shift=cfg.use_shift)
    eye = torch.eye(c, dtype=torch.float32, device=dev)
    if cfg.delta_scale == "corrected" and cfg.use_shift:
        delta = core.delta * (c / n_k)
        core = core._replace(delta=delta, u=core.z @ (eye - delta * core.z))
    if cfg.variant == "eq10_literal":
        u = core.z @ (eye - core.delta * a)
    else:
        u = core.u
    if cfg.causal:
        u = torch.where(tril, u, 0.0)
    return u, core.delta


# --------------------------------------------------------------------------
# Full fused attention.
# --------------------------------------------------------------------------
def ss_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       cfg: SSConfig = SSConfig(), *,
                       scale: Optional[float] = None,
                       kv_valid: Optional[int] = None, block_n: int = 0,
                       block_c: int = 0) -> torch.Tensor:
    """Kernel-backed spectral-shifting attention, shapes (..., n, d);
    differentiable in q, k and v. ``block_n`` / ``block_c``: a dispatch
    plan's tiling (``dispatch.check_tiling`` raises, before any launch on
    CUDA, for one the kernels cannot take; the CPU's plain versions ignore
    it); ``block_c`` reaches K1 and K3 as ``row_block``.

    ``kv_valid`` (host int): only the first ``kv_valid`` positions are
    real; landmark means and the B-side softmax mask the padded tail, so a
    bucket-padded prompt computes what the unpadded call would (outputs
    past ``kv_valid`` are garbage the caller drops). Bidirectional
    self-attention only, and only for padded n > c."""
    *lead, n, d = q.shape
    n_k = k.shape[-2]
    dv = v.shape[-1]
    c = cfg.num_landmarks
    if kv_valid is not None:
        if cfg.causal:
            raise ValueError(
                "kv_valid masking supports the bidirectional (prefill) "
                "variant only; causal bucketing needs dynamic segment masks")
        if n != n_k:
            raise ValueError("kv_valid masking requires self-attention (n == n_k)")
        if n <= c:
            raise ValueError(
                f"kv_valid masking needs padded n ({n}) > num_landmarks "
                f"({c}); run degenerate prompts unpadded instead")
    if n <= c and n_k <= c:
        # Degenerate small-n regime: exact attention, as the reference does.
        return full_attention(q, k, v, causal=cfg.causal, scale=scale)
    if q.is_cuda:
        from repro_torch.kernels.dispatch import check_tiling

        check_tiling(block_n, block_c, c=c, backward=_needs_grad(q, k, v))
    else:
        block_n = block_c = 0
    scale = scale if scale is not None else 1.0 / (d**0.5)
    b = 1
    for s_ in lead:
        b *= s_
    qf = q.reshape(b, n, d).contiguous()
    kf = k.reshape(b, n_k, d).contiguous()
    vf = v.reshape(b, n_k, dv).contiguous()

    if kv_valid is not None:
        kv_valid = int(kv_valid)
        q_l = masked_segment_means(qf, c, kv_valid)
        k_l = masked_segment_means(kf, c, kv_valid)
    else:
        q_l = segment_means(qf, c, via_matmul=cfg.landmark_via_matmul)
        k_l = segment_means(kf, c, via_matmul=cfg.landmark_via_matmul)
    if q_l.shape[-2] != k_l.shape[-2]:
        raise ValueError(
            "spectral-shift attention needs matching landmark counts for Q~ "
            f"and K~, got {q_l.shape[-2]} vs {k_l.shape[-2]}")

    u, delta_core = ss_core_factors(
        q_l, k_l, cfg, scale, n_k if kv_valid is None else kv_valid)
    bv = landmark_summary_op(q_l.contiguous(), kf, vf, scale=scale,
                             causal=cfg.causal, kv_valid=kv_valid,
                             chunk_keys=block_n, row_block=block_c)  # (b, c, dv)
    m_mat = (u.float() @ bv.float()).to(v.dtype)
    if cfg.include_shift_identity and n <= n_k:
        # + delta_ss I_n -> + delta_ss * V on the query-aligned rows of V.
        delta = delta_core.float()
        v_q = vf if n == n_k else vf[:, n_k - n:].contiguous()
    else:
        delta = torch.zeros((b, 1, 1), dtype=torch.float32, device=q.device)
        v_q = vf if n == n_k else torch.zeros((b, n, dv), dtype=vf.dtype,
                                              device=q.device)
    out = query_side_op(qf, k_l.contiguous(), m_mat.contiguous(), v_q,
                        delta.contiguous(), scale=scale, causal=cfg.causal,
                        seq_len_k=n_k, run_rows=block_n)
    return out.reshape(*lead, n, dv)


def nystrom_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            cfg: SSConfig = SSConfig(use_shift=False,
                                                     include_shift_identity=False),
                            *, scale: Optional[float] = None,
                            block_n: int = 0) -> torch.Tensor:
    """Kernel-backed Nystromformer baseline (``ops.py:341``): K1 / K2 with
    delta = 0 and no shifted-identity term."""
    cfg = dataclasses.replace(cfg, use_shift=False, include_shift_identity=False)
    return ss_attention_fused(q, k, v, cfg, scale=scale, block_n=block_n)
