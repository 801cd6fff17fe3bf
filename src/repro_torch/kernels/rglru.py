"""RG-LRU linear recurrence (the recurrent core of recurrentgemma).

:func:`rglru_scan` computes, per (batch, channel) from h_0 = 0,

    h_t = a_t · h_{t-1} + b_t

and returns every h_t.  On CUDA tensors it launches the kernel in
``csrc/rglru.cu`` (one thread per channel walking time, the state in a
register); on CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.rglru_scan_ref`.
"""
from __future__ import annotations

import torch

from . import ops
from .ref import rglru_scan_ref


def check_rglru(a: torch.Tensor, b: torch.Tensor) -> None:
    """Validate the kernel's inputs: float32 a and b of one (B, S, C)
    shape and strides, with a unit-stride last axis."""
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rglru_scan takes float32 tensors, got {a.dtype}, "
                        f"{b.dtype}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a and b must share one (B, S, C) shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.stride() != b.stride() or (a.shape[2] > 1 and a.stride(2) != 1):
        raise ValueError(f"a and b must share strides with a unit-stride "
                         f"last axis, got {a.stride()}, {b.stride()}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, C) float32, a the per-step decay.  Returns the
    states h (B, S, C) float32.  Forward-only: raises where an input
    requires grad in grad mode (:func:`ops.forward_only`)."""
    check_rglru(a, b)
    ops.forward_only("rglru_scan", a, b)
    if not ops.on_cuda(a, b):
        return rglru_scan_ref(a, b)
    bsz, s, c = a.shape
    out = torch.empty((bsz, s, c), dtype=torch.float32, device=a.device)
    if out.numel():
        ops.launch("rglru", "rglru_forward", "rglru_scan", a.device,
                   a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, s, c,
                   a.stride(0), a.stride(1))
    return out
