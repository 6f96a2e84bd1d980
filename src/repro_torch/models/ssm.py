"""The recurrent cells (``repro/models/ssm.py``): the depthwise causal
conv; xLSTM's mLSTM (the stabilised chunk-parallel form the trainer runs,
and its one-token step) and sLSTM (a per-step recurrence); and the Mamba
(S6) selective SSM of the hybrid family, its parameter specs and chunked
scan. One-token decode of a whole block lives in ``serve/decode.py``.

mLSTM and sLSTM are plain torch, as the reference has no Pallas kernel
for them: the mLSTM chunk loop runs ceil(s / chunk) steps of batched
products, the sLSTM loop one step per token (``slstm_scan``).

The reference scans in XLA (``lax.associative_scan`` within a chunk,
``lax.scan`` across chunks), not in Pallas, so this stays plain torch:
within a chunk a log-depth (Hillis-Steele) pass of elementwise ops over
(B, nc, L, di, N), every chunk at once; across chunks a sequential carry of
the (B, di, N) state. The association order differs from the reference's
tree, so results agree to rounding, not bitwise.

Under a sequence shard (``distributed/seq_parallel.py``) ``mamba_forward``
takes a ``shard``: its conv context and entering state come from the
earlier shards. The mLSTM and sLSTM take their entering state through
``state`` (``exact_final`` keeps an mLSTM shard's padded tail out of the
state it hands on).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv (``ssm.py:19``). x (B,S,C), w (W,C), b (C)."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def state_dtype(x: torch.Tensor) -> torch.dtype:
    """A cell's state dtype for inputs of x's: fp32, as the reference's,
    or float64 for a float64 model."""
    return torch.promote_types(x.dtype, torch.float32)


def mlstm_fresh_state(b: int, h: int, dh: int, device, dtype=torch.float32) -> tuple:
    """The mLSTM's start: (C 0 (B,H,Dh,Dh), n 0 (B,H,Dh), m -1e30 (B,H))."""
    return (torch.zeros((b, h, dh, dh), dtype=dtype, device=device),
            torch.zeros((b, h, dh), dtype=dtype, device=device),
            torch.full((b, h), -1e30, dtype=dtype, device=device))


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  ilog: torch.Tensor, flog: torch.Tensor,
                  state: Optional[tuple] = None, chunk: int = 64,
                  exact_final: bool = False):
    """Stabilised chunk-parallel mLSTM (``ssm.py:32``). q/k/v (B,H,S,Dh);
    ilog (B,H,S) the input gate's pre-activation, flog (B,H,S) the forget
    gate's log-sigmoid. s is zero-padded up to a multiple of ``chunk``; a
    fresh state is (C 0, n 0, m -1e30). One named difference: the in-chunk
    decay matrix masks before its exp, so gradients stay finite at the
    configs' own chunk of 256, where the reference's are NaN.
    ``exact_final``: the padded tail's input gates are -1e30 instead of 0,
    so the final state is the state at position s (a zero gate can lift
    the final stabilizer m to 0, which the next tokens' denominators read:
    a sequence shard hands its final state on). The outputs are the same
    either way. Returns (h (B,H,S,Dh) in q's dtype, final (C (B,H,Dh,Dh),
    n (B,H,Dh), m (B,H)) fp32)."""
    b, h, s, dh = q.shape
    k = k / (dh**0.5)
    pad = -s % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        ilog = F.pad(ilog, (0, pad), value=-1e30 if exact_final else 0.0)
        flog = F.pad(flog, (0, pad))
    nc = (s + pad) // chunk
    if state is None:
        c_prev, n_prev, m_prev = mlstm_fresh_state(b, h, dh, q.device, state_dtype(q))
    else:
        c_prev, n_prev, m_prev = state
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    outs = []
    for j in range(nc):
        sl = slice(j * chunk, (j + 1) * chunk)
        qb, kb, vb = q[:, :, sl].float(), k[:, :, sl].float(), v[:, :, sl].float()
        ib, fb = ilog[:, :, sl].float(), flog[:, :, sl].float()
        csf = torch.cumsum(fb, dim=-1)                       # (B,H,L)
        g = torch.cummax(ib - csf, dim=-1).values
        m_new = torch.maximum(m_prev[..., None] + csf, csf + g)
        # D[s, r] = exp(csf_s - csf_r + i_r - m_s), r <= s. The mask is
        # taken before the exp: above the diagonal lw grows with the chunk
        # (-csf is a sum of log-sigmoids) and its exp overflows at chunks of
        # ~128+, and the reference's where(mask, exp(lw), 0) then gives NaN
        # gradients (0 * inf); the forward is the same either way.
        lw = csf[..., :, None] - csf[..., None, :] + ib[..., None, :] - m_new[..., :, None]
        dmat = torch.exp(torch.where(mask, lw, float("-inf")))  # (B,H,L,L)
        w = (qb @ kb.transpose(-1, -2)) * dmat
        h_intra = w @ vb
        inter = torch.exp(m_prev[..., None] + csf - m_new)   # (B,H,L)
        h_inter = torch.einsum("bhde,bhse->bhsd", c_prev, qb) * inter[..., None]
        n_eff = inter[..., None] * n_prev[..., None, :] + dmat @ kb
        denom = torch.maximum(torch.abs(torch.einsum("bhsd,bhsd->bhs", qb, n_eff)),
                              torch.exp(-m_new))
        outs.append(((h_intra + h_inter) / denom[..., None]).to(q.dtype))
        m_last = m_new[..., -1]
        wstate = torch.exp(csf[..., -1:] - csf + ib - m_last[..., None])  # (B,H,L)
        decay = torch.exp(m_prev + csf[..., -1] - m_last)
        c_prev = (decay[..., None, None] * c_prev
                  + torch.einsum("bhr,bhrd,bhre->bhde", wstate, vb, kb))
        n_prev = decay[..., None] * n_prev + torch.einsum("bhr,bhrd->bhd", wstate, kb)
        m_prev = m_last
    return torch.cat(outs, dim=2)[:, :, :s], (c_prev, n_prev, m_prev)


def mlstm_step(q, k, v, ilog, flog, state):
    """One-token mLSTM (``ssm.py:139``). q/k/v (B,H,Dh); ilog/flog (B,H);
    state (C, n, m). Returns (h (B,H,Dh) fp32, new state)."""
    c_prev, n_prev, m_prev = state
    dh = q.shape[-1]
    k = k.float() / (dh**0.5)
    q, v = q.float(), v.float()
    f32, i32 = flog.float(), ilog.float()
    m_new = torch.maximum(f32 + m_prev, i32)
    fprime = torch.exp(f32 + m_prev - m_new)[..., None]
    iprime = torch.exp(i32 - m_new)[..., None]
    c_new = fprime[..., None] * c_prev + iprime[..., None] * (v[..., :, None] * k[..., None, :])
    n_new = fprime * n_prev + iprime * k
    num = torch.einsum("bhde,bhe->bhd", c_new, q)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n_new, q)), torch.exp(-m_new))
    return num / den[..., None], (c_new, n_new, m_new)


def slstm_cell(pre: torch.Tensor, c, n, m):
    """One sLSTM step from the fp32 gate pre-activations pre (B,H,4,Dh)
    (input, forget, cell, output) and the state (c, n, m). Returns (c, n,
    m, h)."""
    il, fl, zl, ol = pre.unbind(2)
    m_new = torch.maximum(fl + m, il)
    i_p = torch.exp(il - m_new)
    f_p = torch.exp(fl + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(zl)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(ol) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, m_new, h_new


def slstm_fresh_state(b: int, h: int, dh: int, device, dtype=torch.float32) -> tuple:
    """The sLSTM's start: (c 0, n 0, m -1e30, h 0), each (B,H,Dh)."""
    zeros = torch.zeros((b, h, dh), dtype=dtype, device=device)
    return (zeros, zeros, torch.full_like(zeros, -1e30), zeros)


def slstm_scan(x_gates: torch.Tensor, r_w: torch.Tensor, state: Optional[tuple] = None):
    """Recurrent sLSTM over time (``ssm.py:161``), one step per token.
    x_gates (B,S,H,4,Dh) the gates' pre-activations from x; r_w (H,4,Dh,Dh)
    the block-diagonal recurrent weights; a fresh state is (c 0, n 0,
    m -1e30, h 0). Returns (h (B,S,H,Dh) in x_gates' dtype, final (c, n,
    m, h) fp32)."""
    b, s, h, _, dh = x_gates.shape
    if state is None:
        state = slstm_fresh_state(b, h, dh, x_gates.device, state_dtype(x_gates))
    c, n, m, hprev = state
    # the recurrent weights laid out once as (H, Dh, 4 Dh) for a batched
    # product per step: an einsum against (H, 4, Dh, Dh) copies them into
    # that layout at every step, and autograd keeps each copy (4 MiB a
    # step at xLSTM-350M's width)
    rw = r_w.float().permute(0, 2, 1, 3).reshape(h, dh, 4 * dh)
    hs = []
    for t in range(s):
        rec = torch.bmm(hprev.transpose(0, 1), rw).view(h, b, 4, dh).transpose(0, 1)
        c, n, m, hprev = slstm_cell(x_gates[:, t].float() + rec, c, n, m)
        hs.append(hprev)
    return torch.stack(hs, dim=1).to(x_gates.dtype), (c, n, m, hprev)


def mamba_specs(d_model: int, d_inner: int, state: int, conv_width: int,
                dt_rank: int) -> dict:
    """``ssm.py:195``."""
    return {
        "w_in": ParamSpec((d_model, 2 * d_inner), ("embed", "ff")),
        "conv_w": ParamSpec((conv_width, d_inner), (None, "ff"), scale=0.3),
        "conv_b": ParamSpec((d_inner,), ("ff",), init="zeros"),
        "w_bc": ParamSpec((d_inner, 2 * state), ("ff", None)),
        "w_dt": ParamSpec((d_inner, dt_rank), ("ff", None)),
        "w_dt_out": ParamSpec((dt_rank, d_inner), (None, "ff")),
        "b_dt": ParamSpec((d_inner,), ("ff",), init="zeros"),
        "a_log": ParamSpec((d_inner, state), ("ff", None), init="zeros"),
        "d_skip": ParamSpec((d_inner,), ("ff",), init="ones"),
        "w_out": ParamSpec((d_inner, d_model), ("ff", "embed")),
    }


def _linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along ``dim`` from h = 0:
    returns (prod of a up to t, h_t). Hillis-Steele: ceil(log2 L) passes,
    each combining every position with the one ``off`` before it; slices
    and a concatenation, so autograd keeps only each pass's inputs."""
    n = a.shape[dim]
    off = 1
    while off < n:
        head_a, head_b = a.narrow(dim, 0, off), b.narrow(dim, 0, off)
        cur_a, cur_b = a.narrow(dim, off, n - off), b.narrow(dim, off, n - off)
        prev_a, prev_b = a.narrow(dim, 0, n - off), b.narrow(dim, 0, n - off)
        b = torch.cat([head_b, cur_a * prev_b + cur_b], dim=dim)
        a = torch.cat([head_a, cur_a * prev_a], dim=dim)
        off *= 2
    return a, b


def mamba_forward(p: dict, x: torch.Tensor, state_dim: int, chunk: int = 256,
                  state: Optional[tuple] = None, shard=None):
    """Selective SSM (``ssm.py:210``). x (B,S,D) -> (out (B,S,D),
    (h_final (B,di,N) fp32, conv_state (B,W-1,di))). ``state`` is an
    optional input ``(h0, conv_state)``. ``abar`` / ``bbar`` are computed
    in fp32 and stored in the compute dtype, as the reference stores
    them; the scan upcasts again.

    ``shard`` (``distributed/seq_parallel.py:SeqShard``): x is this
    rank's slice of a sequence split over ranks. The conv's context is the
    previous shard's last W - 1 rows of u (``shard.halo``, taken as the
    ``state[1]`` input); the scan runs from h = 0, the shard's total decay
    (the product of its abar) and end state go to ``shard.carry``, which
    gives the state entering the shard, and the carry across chunks runs
    again from it (the in-chunk scans, affine in the carry, are not
    rerun). ``h_final`` is then the global state at the shard's end."""
    b, s, _ = x.shape
    dt = x.dtype
    ui = x @ p["w_in"].to(dt)                                   # (B,S,2di)
    di = ui.shape[-1] // 2
    u, z = ui[..., :di], ui[..., di:]
    width = p["conv_w"].shape[0]
    if shard is not None:
        if state is not None:
            raise ValueError("mamba_forward: an input state and a sequence shard")
        state = (None, shard.halo(u, width - 1))
    if state is not None and state[1] is not None:
        ctx = torch.cat([state[1].to(dt), u], dim=1)
        u_conv = _causal_conv(ctx, p["conv_w"], p["conv_b"])[:, width - 1:]
        conv_state = ctx[:, -(width - 1):]
    else:
        u_conv = _causal_conv(u, p["conv_w"], p["conv_b"])
        conv_state = F.pad(u, (0, 0, width - 1, 0))[:, -(width - 1):]
    u_conv = F.silu(u_conv)

    bc = u_conv @ p["w_bc"].to(dt)                              # (B,S,2N)
    b_mat, c_mat = bc[..., :state_dim], bc[..., state_dim:]
    dt_pre = (u_conv @ p["w_dt"].to(dt)) @ p["w_dt_out"].to(dt)
    delta = F.softplus(dt_pre.float() + p["b_dt"].float())      # (B,S,di)
    a = -torch.exp(p["a_log"].float())                          # (di,N)
    abar = torch.exp(delta[..., None] * a).to(dt)               # (B,S,di,N)
    bbar = (delta[..., None] * b_mat.float()[..., None, :]
            * u_conv.float()[..., None]).to(dt)

    h0 = (torch.zeros((b, di, state_dim), dtype=torch.float32, device=x.device)
          if state is None or state[0] is None else state[0].float())
    pad = -s % chunk
    if pad:
        abar = F.pad(abar, (0, 0, 0, 0, 0, pad), value=1.0)
        bbar = F.pad(bbar, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk
    acum, bcum = _linear_scan(abar.float().reshape(b, nc, chunk, di, state_dim),
                              bbar.float().reshape(b, nc, chunk, di, state_dim), 2)

    def carry_across(h):
        """The carry into each chunk from ``h`` (h after the previous
        chunk's last position) and the state after the last."""
        carries = []
        for j in range(nc):
            carries.append(h)
            h = acum[:, j, -1] * h + bcum[:, j, -1]
        return carries, h

    carries, h = carry_across(h0)
    if shard is not None:
        decay = acum[:, 0, -1]
        for j in range(1, nc):
            decay = acum[:, j, -1] * decay
        carries, h = carry_across(shard.carry(decay, h))
    hs = acum * torch.stack(carries, dim=1)[:, :, None] + bcum  # (B,nc,L,di,N)
    hs = hs.reshape(b, nc * chunk, di, state_dim)[:, :s]
    y = torch.einsum("bsdn,bsn->bsd", hs, c_mat.float())
    y = y + p["d_skip"].float() * u_conv.float()
    out = (y.to(dt) * F.silu(z)) @ p["w_out"].to(dt)
    return out, (h, conv_state)
