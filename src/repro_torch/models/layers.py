"""Core neural layers the port's model families need.

Only :func:`rms_norm` so far (the RWKV-6 family uses no attention).  The
JAX package's sharding constraints have no counterpart on one device.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 scaled by ``1 + scale``, cast back to x's
    dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(dt)
