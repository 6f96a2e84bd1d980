"""Gradient compression for the data-parallel all-reduce
(``repro/optim/compression.py``).

int8 per-tensor quantization with error feedback (EF-SGD style): each
step sends int8 (4x less than fp32) plus one fp32 scale; the quantization
residual is carried and added back next step, so the method is unbiased
in the long run.

``compressed_psum`` is the collective over a mesh axis (quantize, sum the
int8 payloads in int32, mean-combine the scales, dequantize);
``compress`` / ``decompress`` are the pure pieces. The trainer refuses
``grad_compression``, as before: the reference's trainer accepts it and
reads it nowhere.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Compressed(NamedTuple):
    q: torch.Tensor      # int8 payload
    scale: torch.Tensor  # () fp32


def compress(x: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """x (+ carried residual) -> (Compressed, new_residual)
    (``compression.py:25``): scale = max|x| / 127 (at least 1e-12 / 127),
    q = round-half-to-even(x / scale) clipped to [-127, 127]."""
    x32 = x.float()
    if residual is not None:
        x32 = x32 + residual
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    new_residual = x32 - q.float() * scale
    return Compressed(q=q, scale=scale), new_residual


def decompress(c: Compressed) -> torch.Tensor:
    return c.q.float() * c.scale


def compressed_psum(x: torch.Tensor, mesh, axis, residual=None):
    """Quantized all-reduce of x over the mesh axis (or axes) ``axis``
    (``compression.py:40``): the int8 payloads summed in int32 (no overflow
    below 2^23 ranks), the scales mean-combined, a cheap stand-in for
    per-rank dequantize-then-sum that keeps 1 byte an element on the wire.
    Returns (the reduced fp32 tensor, the new residual)."""
    c, new_res = compress(x, residual)
    qsum = mesh.all_reduce(c.q.to(torch.int32), "sum", axis)
    ssum = mesh.all_reduce(c.scale.reshape(1), "sum", axis)
    n = mesh.axis_size(axis)
    return qsum.float() * (ssum[0] / n), new_res


def make_compressed_grad_allreduce(mesh, axis_name: str = "data"):
    """f(grads_tree, residual_tree) -> (reduced_tree, new_residuals): the
    quantized all-reduce of every leaf over ``axis_name``
    (``compression.py:56``)."""
    from repro_torch.models.params import tree_leaves, tree_map

    def _reduce(grads, residuals):
        pairs = [compressed_psum(g, mesh, axis_name, r)
                 for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
        reduced, new_res = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
        return (tree_map(lambda _: next(reduced), grads),
                tree_map(lambda _: next(new_res), grads))

    return _reduce
