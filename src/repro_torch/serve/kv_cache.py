"""Decode-state layout (``repro/serve/kv_cache.py``) of every family:
dense and ``vlm`` GQA, ``moe`` with GQA or MLA, ``hybrid`` (Hymba),
``ssm`` (xLSTM) and ``audio`` (Whisper's decoder).

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
axis, so they stay dense per lane beside the paged attention leaves.

xLSTM (the ``ssm`` branch, :187): an unrolled list, each block
``{"kind_mlstm": {c (B, H, Dh, Dh), n (B, H, Dh), m (B, H), conv (B, W - 1,
di)}}`` or ``{"kind_slstm": {c, n, m, h (B, H, Dh)}}``, every leaf fp32
but the conv tail and zero to start, m included (the forward's fresh state
has m = -1e30; serving replays tokens from this zero state, as the
reference's engine does). No leaf has a ``cache_seq`` axis.

Whisper (the ``audio`` branch, :195): an unrolled per-layer list of GQA
caches (``scan_layers=False``) plus ``cross_k`` / ``cross_v`` (L, B, H,
1500, Dh), the encoder's keys and values, which no serving path writes:
the engine serves them as zeros, as the reference's does.

The engine's storage (``serve/paged.py:storage_layout``) stacks the leaves
of a per-layer list in layer order and keys each leaf by its last path
name, or, where two groups share a last name (xLSTM's mLSTM and sLSTM
``c``, ``n``, ``m``), by its path below the layer index
(``kind_mlstm/c``).

Leaves without a dtype are stored in fp32, as the reference stores them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ENCODER_SEQ
from repro_torch.models.model import is_slstm
from repro_torch.models.params import (PATH_SEP, ParamSpec, flatten_with_paths, map_specs,
                                       stack_layer_specs)

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


def _mlstm_state(cfg: ModelConfig, b: int) -> dict:
    """``kv_cache.py:89``."""
    di = 2 * cfg.d_model
    h = cfg.num_heads
    dh = di // h
    f32 = torch.float32
    return {
        "c": ParamSpec((b, h, dh, dh), (BATCH, "heads", None, None), init="zeros", dtype=f32),
        "n": ParamSpec((b, h, dh), (BATCH, "heads", None), init="zeros", dtype=f32),
        "m": ParamSpec((b, h), (BATCH, "heads"), init="zeros", dtype=f32),
        "conv": ParamSpec((b, cfg.conv_width - 1, di), (BATCH, None, "ff_act"), init="zeros"),
    }


def _slstm_state(cfg: ModelConfig, b: int) -> dict:
    """``kv_cache.py:102``."""
    h = cfg.num_heads
    dh = cfg.d_model // h
    return {k: ParamSpec((b, h, dh), (BATCH, "heads", None), init="zeros",
                         dtype=torch.float32) for k in ("c", "n", "m", "h")}


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Full decode-state ParamSpec tree (``kv_cache.py:187``)."""
    specs: dict = {"pos": ParamSpec((), (), init="zeros", dtype=torch.int32)}
    if cfg.family == "ssm":
        specs["layers"] = [
            {"kind_slstm": _slstm_state(cfg, batch)} if is_slstm(cfg, i)
            else {"kind_mlstm": _mlstm_state(cfg, batch)} for i in range(cfg.num_layers)]
        return specs
    if cfg.family == "audio":
        h, dh = cfg.num_heads, cfg.resolved_head_dim
        specs["layers"] = [_gqa_cache(cfg, batch, seq_len) for _ in range(cfg.num_layers)]
        for name in ("cross_k", "cross_v"):
            specs[name] = ParamSpec((cfg.num_layers, batch, h, ENCODER_SEQ, dh),
                                    ("layers", BATCH, "heads", None, None), init="zeros")
        return specs
    if cfg.family in ("dense", "vlm") and not cfg.mla:
        layer = _gqa_cache(cfg, batch, seq_len)
    elif cfg.family == "moe":
        layer = (_mla_cache if cfg.mla else _gqa_cache)(cfg, batch, seq_len)
    elif cfg.family == "hybrid":
        layer = {"attn": _gqa_cache(cfg, batch, seq_len),
                 "mamba": _mamba_state(cfg, batch, cfg.d_model)}
    else:
        raise NotImplementedError(f"unknown family {cfg.family!r}")
    specs["layers"] = (stack_layer_specs(layer, cfg.num_layers) if cfg.scan_layers
                       else [layer for _ in range(cfg.num_layers)])
    return specs


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


class StorageLeaf(NamedTuple):
    """One leaf group of the engine's storage: ``layers`` the decoder layer
    indices it holds, in order; ``shape`` the B=1 spec's shape with the
    layer and batch axes removed; ``seq_axis`` the ``cache_seq`` position
    in ``shape`` (None: lane-dense state)."""
    layers: tuple
    shape: tuple
    dtype: Optional[torch.dtype]
    seq_axis: Optional[int]


def _storage_sub(path: str) -> tuple:
    """(the path below the layer index, the layer or None) of a cache
    leaf's path ("/" or "::" joined): a per-layer list's leaf has its
    layer; a stacked or top-level layer-first leaf none."""
    parts = path.strip("/").replace(PATH_SEP, "/").split("/")
    if parts[0] == "layers" and parts[1].isdigit():   # a per-layer list
        return "/".join(parts[2:]), int(parts[1])
    return "/".join(parts[1:] if parts[0] == "layers" else parts), None


def _storage_keys(subs) -> dict:
    """{sub path: storage key}: the last path name, or the sub path where
    two groups share a last name."""
    last = [sub.rsplit("/", 1)[-1] for sub in subs]
    unique = len(set(last)) == len(last)
    return {sub: (sub.rsplit("/", 1)[-1] if unique else sub) for sub in subs}


def storage_layout(cfg: ModelConfig, seq_len: int) -> dict:
    """``{key: StorageLeaf}`` of the engine's storage: every leaf of the
    B=1 cache tree but ``pos``, the leaves of a per-layer list stacked in
    layer order under one key, a stacked (or top-level, layer-first) leaf
    as it is. A leaf is keyed by its last path name, or, when two groups
    share one (xLSTM's mLSTM and sLSTM ``c``, ``n``, ``m``), by its path
    below the layer index (``kind_mlstm/c``), for every leaf of the
    model."""
    groups: dict = {}
    for path, spec, seq_axis in cache_leaf_layout(cfg, seq_len):
        if path.strip("/") == "pos":
            continue
        sub, layer = _storage_sub(path)
        lead = 1 if layer is not None else 2
        rest = spec.shape[lead:]
        ax = None if seq_axis is None else seq_axis - lead
        if sub not in groups:
            ids = () if layer is not None else tuple(range(spec.shape[0]))
            groups[sub] = StorageLeaf(ids, rest, spec.dtype, ax)
        if layer is not None:
            groups[sub] = groups[sub]._replace(layers=groups[sub].layers + (layer,))
    keys = _storage_keys(groups)
    return {keys[sub]: leaf for sub, leaf in groups.items()}


def storage_from_tree(cache: dict) -> dict:
    """A whole cache tree of ``cache_specs``'s structure (the dry-run's and
    the reference's) in the engine's storage keys (``storage_layout``'s):
    ``{key: layer-stacked tensor}``, a per-layer list's leaves stacked in
    layer order, stacked and top-level layer-first leaves as they are,
    ``pos`` left out."""
    groups: dict = {}
    for path, t in flatten_with_paths({k: v for k, v in cache.items() if k != "pos"}).items():
        sub, layer = _storage_sub(path)
        if layer is None:
            groups[sub] = t
        else:
            groups.setdefault(sub, []).append(t)
    keys = _storage_keys(groups)
    return {keys[sub]: torch.stack(t) if isinstance(t, list) else t
            for sub, t in groups.items()}


@functools.lru_cache(maxsize=64)
def layer_slots(cfg: ModelConfig) -> tuple:
    """Per decoder layer, ``((key, slot), ...)``: the storage keys holding
    that layer's leaves and the layer's index within each key's stack
    (cached by config: every decode step reads it)."""
    slots: list = [[] for _ in range(cfg.num_layers)]
    for key, leaf in storage_layout(cfg, 1).items():
        for j, i in enumerate(leaf.layers):
            slots[i].append((key, j))
    return tuple(tuple(s) for s in slots)


def layer_leaves(cfg: ModelConfig, layers: dict, i: int) -> dict:
    """Layer ``i``'s leaves from a storage-keyed dict of layer-stacked
    tensors (the engine's storage, or views of it)."""
    return {key: layers[key][j] for key, j in layer_slots(cfg)[i]}


def stream_leaf_indices(cfg: ModelConfig, seq_len: int) -> dict:
    """Flat-leaf indices (``cache_leaf_layout`` order) of the streaming
    stat leaves, keyed by leaf name, in layer order."""
    out = {name: [] for name in STREAM_STAT_LEAVES}
    for i, (path, _spec, _ax) in enumerate(cache_leaf_layout(cfg, seq_len)):
        name = path.rsplit("/", 1)[-1]
        if name in out:
            out[name].append(i)
    return out
