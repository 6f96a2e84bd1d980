"""Decode-state layout (``repro/serve/kv_cache.py``) of the families the
port serves: dense GQA, ``moe`` with GQA or MLA, and ``hybrid`` (Hymba).

Per layer (stacked on a leading ``layers`` axis), GQA:

* ``k``/``v`` (B, Hkv, S, Dh): the sequence-shaped leaves, the ones the
  paged engine keeps in shared block pools;
* ``q_lmk``/``k_lmk`` (B, H|Hkv, c, Dh): running landmark segment SUMS
  (counts derive from ``pos``);
* ``bv_m``/``bv_l`` (B, H, c, 1) and ``bv_acc`` (B, H, c, Dh): the fp32
  streaming online-softmax partials of the B-side summary
  (serve/decode_state.py).

MLA (``_mla_cache``, :61), served absorbed: the sequence leaves are the
kv_lora ``latent`` (r wide) and the rotary key ``rope`` (dr wide), the
keys are their concatenation (de = r + dr) and the values the latents.
The reference stores them (B, S, r) and (B, S, dr) and its ``k_lmk``
(B, c, de); here each carries a unit axis where GQA has its kv heads,
(B, 1, S, r), (B, 1, S, dr) and (B, 1, c, de): absorbed MLA is GQA with
one kv head of width de, so the pools, the gathers, the commits and
kernel K5 take it as they take GQA's K/V. ``q_lmk`` is (B, H, c, de),
``bv_acc`` (B, H, c, r).

Hybrid (``cache_specs``' ``hybrid`` branch, :199): each layer is
``{"attn": <GQA leaves>, "mamba": {"ssm_h", "conv"}}``, the mamba state
(``_mamba_state``, :77) being the fp32 SSM state ``ssm_h`` (B, di, N) and
the causal conv's tail ``conv`` (B, W - 1, di). They have no ``cache_seq``
axis, so they stay dense per lane beside the paged attention leaves. Leaf
names are unique across the two groups: the engine's storage keys leaves
by their last path name (``serve/paged.py``).

Leaves without a dtype are stored in fp32, as the reference stores them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec, map_specs, stack_layer_specs

BATCH = "cache_batch"
SEQ = "cache_seq"
STREAM_STAT_LEAVES = ("bv_m", "bv_l", "bv_acc")
MAMBA_LEAVES = ("ssm_h", "conv")


def _gqa_cache(cfg: ModelConfig, b: int, s: int) -> dict:
    h, hkv, dh, c = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                     cfg.num_landmarks)
    f32 = torch.float32
    return {
        "k": ParamSpec((b, hkv, s, dh), (BATCH, "kv_heads", SEQ, None), init="zeros"),
        "v": ParamSpec((b, hkv, s, dh), (BATCH, "kv_heads", SEQ, None), init="zeros"),
        "q_lmk": ParamSpec((b, h, c, dh), (BATCH, "heads", None, None), init="zeros"),
        "k_lmk": ParamSpec((b, hkv, c, dh), (BATCH, "kv_heads", None, None), init="zeros"),
        "bv_m": ParamSpec((b, h, c, 1), (BATCH, "heads", None, None), init="zeros", dtype=f32),
        "bv_l": ParamSpec((b, h, c, 1), (BATCH, "heads", None, None), init="zeros", dtype=f32),
        "bv_acc": ParamSpec((b, h, c, dh), (BATCH, "heads", None, None), init="zeros", dtype=f32),
    }


def _mla_cache(cfg: ModelConfig, b: int, s: int) -> dict:
    r, dr, c, h = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.num_landmarks, cfg.num_heads
    de = r + dr  # effective (absorbed) key dim
    f32 = torch.float32
    return {
        "latent": ParamSpec((b, 1, s, r), (BATCH, "kv_heads", SEQ, None), init="zeros"),
        "rope": ParamSpec((b, 1, s, dr), (BATCH, "kv_heads", SEQ, None), init="zeros"),
        "q_lmk": ParamSpec((b, h, c, de), (BATCH, "heads", None, None), init="zeros"),
        "k_lmk": ParamSpec((b, 1, c, de), (BATCH, "kv_heads", None, None), init="zeros"),
        "bv_m": ParamSpec((b, h, c, 1), (BATCH, "heads", None, None), init="zeros", dtype=f32),
        "bv_l": ParamSpec((b, h, c, 1), (BATCH, "heads", None, None), init="zeros", dtype=f32),
        # values are the kv_lora latents in absorbed MLA decode
        "bv_acc": ParamSpec((b, h, c, r), (BATCH, "heads", None, None), init="zeros", dtype=f32),
    }


def _mamba_state(cfg: ModelConfig, b: int, d_inner: int) -> dict:
    """``kv_cache.py:77``."""
    return {
        "ssm_h": ParamSpec((b, d_inner, cfg.ssm_state), (BATCH, "ff_act", None),
                           init="zeros", dtype=torch.float32),
        "conv": ParamSpec((b, cfg.conv_width - 1, d_inner), (BATCH, None, "ff_act"),
                          init="zeros"),
    }


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Full decode-state ParamSpec tree (``kv_cache.py:187``) of the
    ``dense``, ``moe`` and ``hybrid`` families."""
    if cfg.family == "dense" and not cfg.mla:
        layer = _gqa_cache(cfg, batch, seq_len)
    elif cfg.family == "moe":
        layer = (_mla_cache if cfg.mla else _gqa_cache)(cfg, batch, seq_len)
    elif cfg.family == "hybrid":
        layer = {"attn": _gqa_cache(cfg, batch, seq_len),
                 "mamba": _mamba_state(cfg, batch, cfg.d_model)}
    else:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    layers = (stack_layer_specs(layer, cfg.num_layers) if cfg.scan_layers
              else [layer for _ in range(cfg.num_layers)])
    return {"pos": ParamSpec((), (), init="zeros", dtype=torch.int32),
            "layers": layers}


def cache_leaf_layout(cfg: ModelConfig, seq_len: int) -> list:
    """The B=1 cache tree flattened in the reference's order (sorted keys):
    ``[(path, spec, seq_axis)]`` with ``seq_axis`` the index of the
    ``cache_seq`` dimension (pageable into blocks) or None for fixed-size
    state that stays dense per lane."""
    out = []
    map_specs(lambda path, spec: out.append(
        (path, spec, spec.axes.index(SEQ) if SEQ in spec.axes else None)),
        cache_specs(cfg, 1, seq_len))
    return out


def stream_leaf_indices(cfg: ModelConfig, seq_len: int) -> dict:
    """Flat-leaf indices (``cache_leaf_layout`` order) of the streaming
    stat leaves, keyed by leaf name, in layer order."""
    out = {name: [] for name in STREAM_STAT_LEAVES}
    for i, (path, _spec, _ax) in enumerate(cache_leaf_layout(cfg, seq_len)):
        name = path.rsplit("/", 1)[-1]
        if name in out:
            out[name].append(i)
    return out
