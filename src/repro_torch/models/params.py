"""Parameter-spec trees: shapes, logical axes and initialization.

Mirrors ``repro/models/params.py``. A model declares a nested dict of
``ParamSpec``; ``init_params`` materializes it on a device from an explicit
``torch.Generator``, and ``params_from_numpy`` is the weight bridge that
takes the reference's parameters (``np.asarray`` of each JAX leaf) into the
port with the same layouts (``w_q`` (d, h, dh), ``w_o`` (h, dh, d), the
stacked ``layers`` axis first).
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
    ``device`` defaults to the generator's device."""
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
            sl.copy_(torch.randn(sl.shape, generator=generator, device=device)
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


def count_params(specs) -> int:
    total = [0]

    def add(_p, spec):
        total[0] += int(np.prod(spec.shape))

    map_specs(add, specs)
    return total[0]
