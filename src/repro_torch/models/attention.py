"""Model-level attention (``repro/models/attention.py``): GQA's parameter
specs, the spectral-shift config, the kv-head group broadcast, the
projections and the full-sequence forward the trainer runs; whisper's
decoder-side cross attention; and MLA's
(multi-head latent attention, the DeepSeek-V2 family) specs, its
full-sequence forward and the projections of its absorbed serving form.
Per-head tensors are (B, H, S, Dh)."""
from __future__ import annotations

import torch

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import (SSConfig, chunked_attention, full_attention,
                                        spectral_shift_attention)
from repro_torch.core.landmarks import segment_means
from repro_torch.distributed.mesh import tp_copy
from repro_torch.distributed.sharding import (active_layout, active_seq_sharding,
                                              logical_constraint)
from repro_torch.models.layers import apply_rotary, rotary_angles
from repro_torch.models.params import ParamSpec


def ss_config_from(cfg: ModelConfig, causal: bool = False) -> SSConfig:
    return SSConfig(
        num_landmarks=cfg.num_landmarks,
        pinv_iters=cfg.pinv_iters,
        method=cfg.ss_method,
        include_shift_identity=cfg.include_shift_identity,
        causal=causal,
        landmark_via_matmul=cfg.landmark_via_matmul,
    )


# the impls that run under a sequence shard: the fused kernels'
# context-parallel attention, and exact attention over gathered keys
SHARD_IMPLS = ("spectral_shift_fused", "full", "chunked")
EXACT_IMPLS = ("full", "chunked")


def gather_keys(k: torch.Tensor, v: torch.Tensor, *, causal: bool):
    """Under a sequence shard, k / v (B, H, S_loc, Dh) from every shard of
    the sequence (``kernels/sharded.py:gather_sequence``, one all-gather
    each; the backward sums the cotangents and keeps the rank's rows),
    cut at this shard's end when ``causal`` (the later shards' keys
    reach none of its queries); as they are without a shard. An
    all-gather, not ring attention: a later shard holds more keys and
    does more of the causal work."""
    from repro_torch.distributed.sharding import active_seq_sharding
    from repro_torch.kernels.sharded import gather_sequence

    mesh, axes, _ = active_seq_sharding()
    if not axes:
        return k, v
    n_loc = k.shape[-2]
    end = (mesh.index(axes) + 1) * n_loc if causal else None
    return tuple(gather_sequence(t, mesh, axes, end) for t in (k, v))


def _core_attention(cfg: ModelConfig, impl: str, q, k, v, *, causal: bool):
    """q (B,H,S,Dh) vs k/v (B,H,S,Dh) -> (B,H,S,Dh) (``attention.py:46``).
    ``spectral_shift_fused`` routes through the dispatch registry
    (``kernels/dispatch.py``) with ``cfg.attention_backend`` and
    ``cfg.autotune``: the kernels for CUDA tensors (their plain versions
    for CPU tensors) at the plan's tiling, or the plain-torch route under
    a "jnp" plan or backend. ``spectral_shift`` / ``nystrom`` are that
    plain route; ``chunked`` is exact attention over key blocks. Under a
    sequence shard ``spectral_shift_fused`` runs the context-parallel
    attention, and ``full`` / ``chunked`` take k / v already gathered up
    to the shard's end (``gather_keys``): their causal queries are the last
    n_q positions of the keys, the rank's own rows at their global offset.
    The approximate plain routes would attend over the rank's own rows
    only, and raise."""
    if impl not in SHARD_IMPLS:
        from repro_torch.distributed.sharding import active_seq_sharding

        if active_seq_sharding()[1]:
            raise NotImplementedError(
                f"attention_impl {impl!r} under a sequence shard: only "
                f"{', '.join(repr(i) for i in SHARD_IMPLS)} run sequence-parallel")
    if impl == "full":
        return full_attention(q, k, v, causal=causal)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal)
    if impl == "spectral_shift_fused":
        from repro_torch.kernels.dispatch import dispatch_ss_attention

        return dispatch_ss_attention(q, k, v, ss_config_from(cfg, causal=causal),
                                     backend=cfg.attention_backend,
                                     autotune_enabled=cfg.autotune)
    if impl in ("spectral_shift", "nystrom"):
        ss = ss_config_from(cfg, causal=causal)
        if impl == "nystrom":
            ss = SSConfig(num_landmarks=ss.num_landmarks, pinv_iters=ss.pinv_iters,
                          method=ss.method, use_shift=False,
                          include_shift_identity=False, causal=causal)
        return spectral_shift_attention(q, k, v, ss)
    raise ValueError(f"unknown attention impl {impl!r}")


def _broadcast_kv(x: torch.Tensor, num_heads: int, group: int = 0, head0: int = 0,
                  kv0: int = 0) -> torch.Tensor:
    """(B, Hkv, S, Dh) -> (B, H, S, Dh) by group broadcast (materialized, as
    the reference's reshape of the broadcast is). Under tensor parallelism
    x holds kv heads kv0.. and the result query heads head0.. of
    ``num_heads`` local ones: query head g (GLOBAL index) takes kv head
    g // ``group`` (the model's query heads per kv head)."""
    b, hkv, s, d = x.shape
    if group:
        idx = [(head0 + j) // group - kv0 for j in range(num_heads)]
        if idx == list(range(hkv)):
            return x
        return x.index_select(1, torch.tensor(idx, device=x.device))
    if hkv == num_heads:
        return x
    g = num_heads // hkv
    return x[:, :, None].expand(b, hkv, g, s, d).reshape(b, num_heads, s, d)


def gqa_specs(cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    specs = {
        "w_q": ParamSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "w_k": ParamSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "w_v": ParamSpec((d, hkv, dh), ("embed", "kv_heads", "head_dim")),
        "w_o": ParamSpec((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs.update(
            b_q=ParamSpec((h, dh), ("heads", "head_dim"), init="zeros"),
            b_k=ParamSpec((hkv, dh), ("kv_heads", "head_dim"), init="zeros"),
            b_v=ParamSpec((hkv, dh), ("kv_heads", "head_dim"), init="zeros"),
        )
    return specs


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) @ w (D,H,E) -> (B,H,S,E), the reference's
    ``einsum("bsd,dhe->bhse")``, as one 2-D product (``aten.mm``): a
    product with no batch dims, which ``remat="dots"`` keeps (an einsum
    would dispatch it as a ``bmm`` of batch 1)."""
    b, s, _ = x.shape
    h, e = w.shape[1:]
    return (x @ w.to(x.dtype).reshape(-1, h * e)).reshape(b, s, h, e).transpose(1, 2)


def output_projection(out: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    """out (B,H,S,E) @ w_o (H,E,D) -> (B,S,D), the reference's
    ``einsum("bhse,hed->bsd")``, as one 2-D product (``aten.mm``)."""
    b, h, s, e = out.shape
    return out.transpose(1, 2).reshape(b, s, h * e) @ w_o.to(out.dtype).reshape(h * e, -1)


def gqa_project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, x_kv=None):
    """x (B,S,D) -> q (B,H,S,Dh), k/v (B,Hkv,S,Dh) (from ``x_kv``, default
    x), bias added, no rotary."""
    dt = x.dtype
    x_kv = x if x_kv is None else x_kv
    q = project_heads(x, p["w_q"])
    k = project_heads(x_kv, p["w_k"])
    v = project_heads(x_kv, p["w_v"])
    if cfg.qkv_bias:
        q = q + p["b_q"].to(dt)[None, :, None, :]
        k = k + p["b_k"].to(dt)[None, :, None, :]
        v = v + p["b_v"].to(dt)[None, :, None, :]
    return q, k, v


def gqa_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, impl: str, mode: str = "causal"):
    """Full-sequence GQA attention (``attention.py:129``): projections with
    bias, rotary inside (as ``gqa_project_qkv`` :112 applies it), kv-head
    broadcast, core attention, output projection. Returns (out, None).

    Under tensor parallelism (``distributed.sharding.active_layout``: the
    query heads split over the "model" axes) the rank holds its query
    heads' slices of ``w_q`` / ``b_q`` / ``w_o``: x enters them through
    ``tp_copy`` (its cotangent summed over the heads' axes), the kv heads
    are the rank's own when they split too, else whole (the rank's kv
    cotangent is its share: ``tp_copy`` on k and v), each local query head
    meets its kv head by GLOBAL index, attention runs at the local heads
    and the row-parallel output projection is summed over the heads' axes
    (``logical_constraint``).

    Under a sequence shard ``full`` / ``chunked`` gather the rank's keys
    and values with every other shard's (``gather_keys``) at the kv heads,
    before the group broadcast, so the collective moves H / Hkv times fewer
    bytes."""
    layout = active_layout()
    axes = layout.tp.heads if layout is not None else ()
    tp = None
    if axes:
        mesh, tp = layout.mesh, ",".join(axes)
        x_q = tp_copy(x, mesh.mesh_id, tp)
        q, k, v = gqa_project_qkv(p, cfg, x_q, x_q if layout.tp.kv_heads else x)
    else:
        q, k, v = gqa_project_qkv(p, cfg, x)
    if cfg.rope_theta > 0:
        sin, cos = rotary_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
        sin, cos = sin[:, None], cos[:, None]  # (B,1,S,Dh/2)
        q, k = apply_rotary(q, sin, cos), apply_rotary(k, sin, cos)
    if impl in EXACT_IMPLS:   # under a sequence shard: the kv heads, before the broadcast
        k, v = gather_keys(k, v, causal=(mode == "causal"))
    if tp is None:
        k = _broadcast_kv(k, cfg.num_heads)
        v = _broadcast_kv(v, cfg.num_heads)
    else:
        heads = q.shape[1]
        kv0 = mesh.index(axes) * k.shape[1] if layout.tp.kv_heads else 0
        if not layout.tp.kv_heads:
            k, v = tp_copy(k, mesh.mesh_id, tp), tp_copy(v, mesh.mesh_id, tp)
        group = cfg.num_heads // cfg.num_kv_heads
        k = _broadcast_kv(k, heads, group, mesh.index(axes) * heads, kv0)
        v = _broadcast_kv(v, heads, group, mesh.index(axes) * heads, kv0)
    out = _core_attention(cfg, impl, q, k, v, causal=(mode == "causal"))
    out = output_projection(out.to(x.dtype), p["w_o"])
    return logical_constraint(out, ("batch", "seq", "embed_act"), partial=axes), None


def cross_attention_specs(cfg: ModelConfig) -> dict:
    return gqa_specs(cfg)


def cross_attention_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                            enc_out: torch.Tensor, *, impl: str) -> torch.Tensor:
    """Decoder-side cross attention over the encoder output, bidirectional,
    no rotary (``attention.py:152``). Under an approximate ``impl`` with
    n_q != n_k the landmarks come from each sequence on its own and the
    rectangular score matrix has no diagonal, so the + delta V term is off
    (``attention.py:170-181``): the plain ``spectral_shift_attention``, no
    kernel. n_q == n_k takes ``impl``'s own route.

    Under a sequence shard x holds the rank's rows of the decoder sequence
    and ``enc_out`` the whole encoder output (its rows are whole on every
    rank), as the reference's GSPMD program sees them: n_q is the GLOBAL
    decoder length (the local one times the shard count), and Q~ the
    global segment means (``kernels/sharded.py:global_segment_means``, one
    all-reduce of the landmark sums, whose backward sums Q~'s cotangent:
    every rank's rows use the same Q~). A, U_ss, delta and B are then the
    same on every rank and F is row-local, so each rank's rows are the
    reference's. The exact impls take the rank's queries against the whole
    encoder keys. An approximate impl at a global n_q == n_k would be the
    self-attention route over the whole sequence, which runs only on the
    fused kernels' context-parallel driver: it raises."""
    dt = x.dtype
    q = project_heads(x, p["w_q"])
    k = project_heads(enc_out.to(dt), p["w_k"])
    v = project_heads(enc_out.to(dt), p["w_v"])
    if cfg.qkv_bias:
        q = q + p["b_q"].to(dt)[None, :, None, :]
        k = k + p["b_k"].to(dt)[None, :, None, :]
        v = v + p["b_v"].to(dt)[None, :, None, :]
    k = _broadcast_kv(k, cfg.num_heads)
    v = _broadcast_kv(v, cfg.num_heads)
    mesh, axes, _ = active_seq_sharding()
    shards = mesh.axis_size(axes) if axes else 1
    approximate = impl in ("spectral_shift", "spectral_shift_fused", "nystrom")
    if approximate and x.shape[1] * shards != enc_out.shape[1]:
        ss = dataclasses.replace(ss_config_from(cfg), include_shift_identity=False)
        if shards > 1:
            from repro_torch.kernels import sharded

            q_l = sharded.global_segment_means(q, ss.num_landmarks, mesh, axes)
        else:
            q_l = segment_means(q, ss.num_landmarks, via_matmul=ss.landmark_via_matmul)
        k_l = segment_means(k, ss.num_landmarks, via_matmul=ss.landmark_via_matmul)
        out = spectral_shift_attention(q, k, v, ss, q_landmarks=q_l, k_landmarks=k_l)
    elif approximate and shards > 1:
        raise NotImplementedError(
            f"cross attention under {impl!r} with the global decoder length equal to the "
            f"encoder's ({enc_out.shape[1]}) under a sequence shard: that is the "
            f"self-attention route over the whole sequence, and the plain routes do not "
            f"run under a sequence shard")
    else:
        out = _core_attention(cfg, impl, q, k, v, causal=False)
    return output_projection(out.to(dt), p["w_o"])


# --------------------------------------------------------------------------
# MLA: multi-head latent attention (``attention.py:192-218``). Serving runs
# it absorbed: keys are the rms-normed kv_lora latent beside the shared
# rotary key (de = kv_lora + rope columns, one stream for every head),
# queries are q_nope pushed through w_uk beside the rotary query, and the
# values are the latents themselves, up-projected by w_uv after mixing.
# Training runs the full-sequence ``mla_forward``, which materialises the
# per-head keys and values instead.
# --------------------------------------------------------------------------
def mla_specs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    dh = cfg.resolved_head_dim          # nope dim per head (== value dim)
    dr = cfg.rope_head_dim
    r = cfg.kv_lora_rank
    return {
        "w_q_nope": ParamSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "w_q_rope": ParamSpec((d, h, dr), ("embed", "heads", "head_dim")),
        "w_dkv": ParamSpec((d, r), ("embed", "kv_lora")),
        "w_k_rope": ParamSpec((d, dr), ("embed", "head_dim")),
        "w_uk": ParamSpec((r, h, dh), ("kv_lora", "heads", "head_dim")),
        "w_uv": ParamSpec((r, h, dh), ("kv_lora", "heads", "head_dim")),
        "w_o": ParamSpec((h, dh, d), ("heads", "head_dim", "embed")),
        "norm_kv": ParamSpec((r,), ("kv_lora",), init="ones"),
    }


def mla_scale(cfg: ModelConfig) -> float:
    """The standard MLA score scale, 1 / sqrt(dh + dr)."""
    return (cfg.resolved_head_dim + cfg.rope_head_dim) ** -0.5


def mla_project_kv(p: dict, cfg: ModelConfig, x: torch.Tensor, sin, cos):
    """x (B, S, D) -> the rms-normed latent c_kv (B, S, r) and the rotated
    shared key k_rope (B, S, dr); (sin, cos) broadcast against (B, 1, S,
    dr/2)."""
    from repro_torch.models.layers import rms_norm

    c_kv = rms_norm(x @ p["w_dkv"].to(x.dtype), p["norm_kv"], cfg.norm_eps)
    k_rope = (x @ p["w_k_rope"].to(x.dtype))[:, None]
    return c_kv, apply_rotary(k_rope, sin, cos)[:, 0]


def mla_latents(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """x (B, S, D), positions (B, S) -> latent c_kv (B, S, r) [rms-normed],
    k_rope (B, 1, S, dr) (``attention.py:211``)."""
    sin, cos = rotary_angles(positions, cfg.rope_head_dim, cfg.rope_theta)
    c_kv, k_rope = mla_project_kv(p, cfg, x, sin[:, None], cos[:, None])
    return c_kv, k_rope[:, None]


def mla_project_q(p: dict, cfg: ModelConfig, x: torch.Tensor, sin, cos) -> torch.Tensor:
    """x (B, S, D) -> the absorbed query (B, H, S, r + dr): q_nope through
    w_uk beside the rotated q_rope."""
    q_nope = project_heads(x, p["w_q_nope"])
    q_rope = apply_rotary(project_heads(x, p["w_q_rope"]), sin, cos)
    q_abs = torch.einsum("bhse,rhe->bhsr", q_nope, p["w_uk"].to(x.dtype))
    return torch.cat([q_abs, q_rope], dim=-1)


def mla_output(p: dict, out_lat: torch.Tensor, dtype) -> torch.Tensor:
    """Mixed latents (B, H, S, r) -> up-projected by w_uv, then w_o:
    (B, S, D)."""
    out = torch.einsum("bhsr,rhe->bhse", out_lat.to(dtype), p["w_uv"].to(dtype))
    return output_projection(out, p["w_o"])


def mla_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                *, impl: str, mode: str = "causal") -> torch.Tensor:
    """Full-sequence, non-absorbed MLA (``attention.py:221``): per-head
    k_nope and v up-projected from the latent, the shared rotary key
    broadcast to every head, q = [q_nope, q_rope], scale (dh + dr)^-0.5.
    ``impl`` "full" and "chunked" are exact; every other impl runs the
    plain ``spectral_shift_attention``, as the reference's does, so no
    kernel launches here. Returns (B, S, D)."""
    dt = x.dtype
    dr = cfg.rope_head_dim
    c_kv, k_rope = mla_latents(p, cfg, x, positions)            # (B,S,r), (B,1,S,dr)
    sin, cos = rotary_angles(positions, dr, cfg.rope_theta)
    q_nope = project_heads(x, p["w_q_nope"])
    q_rope = apply_rotary(project_heads(x, p["w_q_rope"]), sin[:, None], cos[:, None])
    k_nope = torch.einsum("bsr,rhe->bhse", c_kv, p["w_uk"].to(dt))
    v = torch.einsum("bsr,rhe->bhse", c_kv, p["w_uv"].to(dt))
    h = cfg.num_heads
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(-1, h, -1, -1)], dim=-1)
    causal = mode == "causal"
    scale = mla_scale(cfg)
    if impl == "full":
        out = full_attention(q, k, v, causal=causal, scale=scale)
    elif impl == "chunked":
        out = chunked_attention(q, k, v, causal=causal, scale=scale)
    else:
        out = spectral_shift_attention(q, k, v, ss_config_from(cfg, causal=causal),
                                       scale=scale)
    return output_projection(out.to(dt), p["w_o"])
