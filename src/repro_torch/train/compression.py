"""Quantized cross-pod gradient mean (the JAX package's
``train/compression.py`` on ``torch.distributed``).

Each leaf is quantized against an absmax shared over the ``pod`` axis,
summed as integers and dequantized:

    scale = max over pods of max|g| / 127
    g_hat = sum over pods of round(g / scale) (int32) * scale / n_pods

The quantized values are int8 (|q| <= 127); they are summed as int32 so
the sum cannot overflow.  The error against the true mean is at most
scale/2 a pod (tested).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import tree_map


def _quantized_mean(g: torch.Tensor, group) -> torch.Tensor:
    """Mean of ``g`` over ``group``'s ranks through int8 values (the one
    rank's quantized ``g`` when ``group`` is None), in float32."""
    g = g.to(torch.float32)
    absmax = torch.max(torch.abs(g))
    if group is not None:
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(absmax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    n = 1
    if group is not None:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        n = dist.get_world_size(group)
    return total.to(torch.float32) * scale / float(n)


@torch.no_grad()
def compressed_pod_mean(grads, mesh, axis: str = "pod"):
    """Average a gradient tree across the mesh's ``axis`` in int8.

    Leaves must be equal in shape on every rank of the axis.  Grads pass
    through unchanged when the mesh has no such axis."""
    if axis not in mesh.axis_names:
        return grads
    group = mesh.group(axis)
    return tree_map(lambda g: _quantized_mean(g, group), grads)
