"""Segmented sums (TedgeDeg degrees and every semiring contraction over
the incidence matrix reduce values into segments).

    out[s] = Σ_{i: ids[i]==s} vals[i]

:func:`segsum` takes ids in any order; :func:`segsum_windowed` requires
them ascending, as the JAX version does.  On CUDA tensors both launch
the kernels in ``csrc/segsum.cu`` (per-block partial sums in shared
memory, then atomics; a sorted reduce-by-key); on CPU tensors they run
the plain version :func:`repro_torch.kernels.ref.segsum_ref`.  The TPU
tile sizes (``block_nnz``, ``block_seg``) do not change the function and
have no counterpart here.
"""
from __future__ import annotations

import functools

import torch

from . import ops
from .ref import segsum_ref

VAL_DTYPES = (torch.float32, torch.bfloat16)


def check_segsum(ids: torch.Tensor, vals: torch.Tensor,
                 num_segments: int) -> None:
    """Validate the kernels' inputs: 1-D integer ids and float32 or bf16
    vals of one length, both contiguous, and ``num_segments >= 0``."""
    if ids.dtype.is_floating_point or ids.dtype.is_complex or \
            ids.dtype == torch.bool:
        raise TypeError(f"ids must be an integer tensor, got {ids.dtype}")
    if vals.dtype not in VAL_DTYPES:
        raise TypeError(f"vals must be float32 or bfloat16, got {vals.dtype}")
    if ids.dim() != 1 or ids.shape != vals.shape:
        raise ValueError(f"ids and vals must share one (nnz,) shape, got "
                         f"{tuple(ids.shape)} and {tuple(vals.shape)}")
    if not (ids.is_contiguous() and vals.is_contiguous()):
        raise ValueError("ids and vals must be contiguous")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")


@functools.cache
def _range_ids() -> int:
    """Ids one range of the windowed kernel takes (its scratch holds one
    16-byte record a range)."""
    return ops.load("segsum").segsum_windowed_range()


def _launch(fn: str, kernel: str, ids: torch.Tensor, vals: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    if not ops.on_cuda(ids, vals):
        return segsum_ref(ids, vals, num_segments)
    ids = ids.to(torch.int32)
    nnz, dev = ids.numel(), vals.device
    if not (nnz and num_segments):
        return torch.zeros(num_segments, dtype=torch.float32, device=dev)
    out = torch.empty(num_segments, dtype=torch.float32, device=dev)
    extra = ()
    if kernel == "segsum_windowed":
        n_ranges = -(-nnz // _range_ids()) + 1   # the first may be short
        scratch = torch.empty(4 * n_ranges, dtype=torch.int32, device=dev)
        extra = (scratch.data_ptr(), n_ranges)
    ops.launch("segsum", fn, kernel, dev, ids.data_ptr(), vals.data_ptr(),
               out.data_ptr(), *extra, nnz, num_segments,
               int(vals.dtype == torch.bfloat16))
    return out


def segsum(ids: torch.Tensor, vals: torch.Tensor,
           num_segments: int) -> torch.Tensor:
    """Segmented sum over ids in any order.  ids: (nnz,) integer (used as
    int32); vals: (nnz,) float32 or bf16, summed in float32.  Ids outside
    [0, num_segments) are dropped.  Returns float32 (num_segments,)."""
    check_segsum(ids, vals, num_segments)
    return _launch("segsum_forward", "segsum", ids, vals, num_segments)


def segsum_windowed(ids: torch.Tensor, vals: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """:func:`segsum` for ids sorted ascending — a sorted reduce-by-key
    that writes each output element once, in a fixed order (two calls
    give the same bits).  Ids outside [0, num_segments) are dropped.  The
    order is not checked: on the card, unsorted ids give wrong values.
    Returns float32 (num_segments,)."""
    check_segsum(ids, vals, num_segments)
    return _launch("segsum_windowed_forward", "segsum_windowed", ids, vals,
                   num_segments)
