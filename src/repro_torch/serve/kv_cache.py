"""Decode-state layout of the dense GQA decoder (``repro/serve/kv_cache.py``).

Per layer (stacked on a leading ``layers`` axis):

* ``k``/``v`` (B, Hkv, S, Dh): the sequence-shaped leaves, the ones the
  paged engine keeps in shared block pools;
* ``q_lmk``/``k_lmk`` (B, H|Hkv, c, Dh): running landmark segment SUMS
  (counts derive from ``pos``);
* ``bv_m``/``bv_l`` (B, H, c, 1) and ``bv_acc`` (B, H, c, Dh): the fp32
  streaming online-softmax partials of the B-side summary
  (serve/decode_state.py).

Leaves without a dtype are stored in fp32, as the reference stores them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec, map_specs, stack_layer_specs

BATCH = "cache_batch"
SEQ = "cache_seq"
STREAM_STAT_LEAVES = ("bv_m", "bv_l", "bv_acc")


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


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Full decode-state ParamSpec tree of a dense model."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    layer = _gqa_cache(cfg, batch, seq_len)
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
