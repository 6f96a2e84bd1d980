"""Parameter-spec trees: shapes, logical axes and initialization.

Mirrors ``repro/models/params.py``. A model declares a nested dict of
``ParamSpec``; ``init_params`` materializes it on a device from an explicit
``torch.Generator``, and ``params_from_numpy`` is the weight bridge that
takes the reference's parameters (``np.asarray`` of each JAX leaf) into the
port with the same layouts (``w_q`` (d, h, dh), ``w_o`` (h, dh, d), the
stacked ``layers`` axis first). Under a parameter layout
(``distributed/sharding.py:param_layout``) ``shard_tree`` cuts a whole
tree to a rank's slices and ``gather_tree`` puts the whole tensors back
together on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis names, len == len(shape)
    init: str = "normal"             # normal | zeros | ones
    scale: Optional[float] = None    # stddev override (default: fan-in)
    dtype: Optional[torch.dtype] = None  # per-param dtype override


def map_specs(fn: Callable[[str, ParamSpec], Any], specs, path: str = ""):
    """Apply ``fn(path, spec)`` to every ``ParamSpec`` of a nested dict/list
    tree (dict keys in sorted order, as the reference flattens them)."""
    if isinstance(specs, ParamSpec):
        return fn(path, specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], f"{path}/{k}") for k in sorted(specs)}
    if isinstance(specs, list):
        return [map_specs(fn, s, f"{path}/{i}") for i, s in enumerate(specs)]
    raise TypeError(f"unexpected spec tree node {type(specs)}")


def _fan_in_scale(spec: ParamSpec) -> float:
    if spec.scale is not None:
        return spec.scale
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    return fan_in**-0.5


def init_params(specs, generator: torch.Generator, *,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None):
    """Materialize parameters: normal leaves are N(0, 1) * fan-in scale,
    drawn from ``generator`` leaf by leaf in path order (a stacked leaf one
    layer slice at a time, so the fp32 draw never holds a whole stack).
    ``device`` defaults to the generator's device; on another device the
    leaves hold what the generator's device draws, copied over a slice at
    a time."""
    device = torch.device(device) if device is not None else generator.device

    def make(_path, spec: ParamSpec):
        pdt = spec.dtype or dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=pdt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=pdt, device=device)
        scale = _fan_in_scale(spec)
        out = torch.empty(spec.shape, dtype=pdt, device=device)
        slices = out if spec.axes[:1] == ("layers",) else out[None]
        for sl in slices:
            sl.copy_(torch.randn(sl.shape, generator=generator, device=generator.device)
                     * scale)
        return out

    return map_specs(make, specs)


def stack_layer_specs(layer_specs, num_layers: int):
    """Prepend a stacked ``layers`` dimension to every spec in a layer tree."""
    return map_specs(
        lambda _p, s: ParamSpec(
            shape=(num_layers, *s.shape), axes=("layers", *s.axes),
            init=s.init, scale=s.scale, dtype=s.dtype,
        ),
        layer_specs,
    )


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Weight bridge: a nested dict/list of numpy arrays (the reference's
    parameters through ``np.asarray``) -> the same tree of tensors on
    ``device``, layouts unchanged. ``dtype`` casts floating leaves."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def params_to_numpy(tree):
    """The reverse of ``params_from_numpy``: the same tree with each tensor
    copied to a host numpy array (a copy, so later in-place updates of the
    tensors never reach it). bf16 leaves have no numpy type and raise."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy(v) for v in tree]
    if tree.dtype == torch.bfloat16:
        raise TypeError("params_to_numpy: bf16 has no numpy dtype; cast first")
    return tree.detach().to("cpu", copy=True).numpy()


PATH_SEP = "::"


def flatten_with_paths(tree, prefix: str = "") -> dict[str, Any]:
    """{path: leaf} of a nested dict / list / NamedTuple tree, in the order
    the reference's pytrees flatten in: dict keys sorted, list items and
    NamedTuple fields in order. A path joins the keys, indices and field
    names with ``::``, as ``jax.tree_util.tree_flatten_with_path`` names
    them (``params::layers::attn::w_q``, ``opt::step``)."""
    def key(k):
        return f"{prefix}{PATH_SEP}{k}" if prefix else str(k)

    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten_with_paths(tree[k], key(k)))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            out.update(flatten_with_paths(getattr(tree, name), key(name)))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            out.update(flatten_with_paths(t, key(i)))
    else:
        out[prefix] = tree
    return out


def unflatten_with_paths(target, leaves: dict, prefix: str = ""):
    """Rebuild ``target``'s structure with the leaves of ``leaves``, keyed as
    ``flatten_with_paths`` keys them."""
    def key(k):
        return f"{prefix}{PATH_SEP}{k}" if prefix else str(k)

    if isinstance(target, dict):
        return {k: unflatten_with_paths(v, leaves, key(k)) for k, v in target.items()}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(unflatten_with_paths(getattr(target, f), leaves, key(f))
                              for f in target._fields))
    if isinstance(target, (list, tuple)):
        return type(target)(unflatten_with_paths(t, leaves, key(i))
                            for i, t in enumerate(target))
    return leaves[prefix]


def tree_leaves(tree) -> list:
    """Leaves of a nested dict / list / NamedTuple tree, in
    ``flatten_with_paths`` order."""
    return list(flatten_with_paths(tree).values())


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), visited in ``tree_leaves`` order; dicts,
    lists and NamedTuples are rebuilt."""
    rests = [flatten_with_paths(r) for r in rest]
    out = {path: fn(leaf, *(r[path] for r in rests))
           for path, leaf in flatten_with_paths(tree).items()}
    return unflatten_with_paths(tree, out)


def shard_leaf(t: torch.Tensor, placement, mesh) -> torch.Tensor:
    """The rank's slice of a whole tensor at its ``placement``
    (``distributed.sharding.Placement``): each dimension cut into as many
    equal parts as its mesh axes span ranks, the part at the rank's flat
    index over them (a contiguous copy)."""
    for dim, axes in enumerate(placement.dims):
        if axes:
            t = t.chunk(mesh.axis_size(axes), dim)[mesh.index(axes)]
    return t.contiguous()


def shard_tree(tree, placements, mesh):
    """``shard_leaf`` over a tree and its placements (same structure)."""
    return tree_map(lambda t, p: shard_leaf(t, p, mesh), tree, placements)


def gather_tree(tree, placements, mesh, device=None):
    """The whole tensors of a tree of slices, on every rank: each split
    dimension all-gathered over its axes (a collective: every rank calls
    it, in the same order), each whole tensor moved to ``device`` (default:
    where its slice is) before the next is gathered."""
    def gather(t, placement):
        t = t.detach()
        for dim, axes in enumerate(placement.dims):
            if axes:
                t = mesh.all_gather(t, axes, dim=dim)
        return t if device is None else t.to(device)

    return tree_map(gather, tree, placements)


def abstract_params(specs, dtype: torch.dtype = torch.float32):
    """The parameter tree as tensors on the ``meta`` device, shapes and
    dtypes only (a spec's own dtype, else ``dtype``): the dry-run's
    counterpart of the reference's ``jax.ShapeDtypeStruct`` tree
    (``params.py:65``); allocates nothing."""
    return map_specs(lambda _p, s: torch.empty(s.shape, dtype=s.dtype or dtype,
                                               device="meta"), specs)


def logical_axes(specs):
    """The tree of logical-axis tuples, aligned with the parameter tree
    (``params.py:72``)."""
    return map_specs(lambda _p, s: s.axes, specs)


def count_params(specs) -> int:
    total = [0]

    def add(_p, spec):
        total[0] += int(np.prod(spec.shape))

    map_specs(add, specs)
    return total[0]
