"""ELL-format semiring SpMV (PageRank / background model / matvec chains).

D4M incidence matrices are near-regular (one nnz per header field), so
the device lowering packs CSR rows to ELL: a fixed ``k_max`` slots per
row, padded with ``col == -1``.  :func:`spmv_ell` computes

    y[r] = ⊕_k vals[r,k] ⊗ x[cols[r,k]]

under ``plus_times`` or ``max_times`` — the CUDA kernel in
``csrc/ell.cu`` on a CUDA tensor, the plain version in
:mod:`repro_torch.kernels.ref` on a CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ops
from .ref import RINGS, spmv_ell_ref


class EllOverflowError(ValueError):
    """A CSR row holds more entries than the ELL pack's ``k_max``.

    Truncating would silently drop nnz (wrong query answers), so the
    pack refuses by default.  Raise ``k_max`` (the device lowering uses
    ``max(nnz per row)``), route the payload through the CSR/COO path
    instead, or pass ``on_overflow='truncate'`` to accept the loss
    explicitly (top-k style sketches only).
    """

    def __init__(self, n_over: int, worst: int, k_max: int):
        self.n_over = n_over
        self.worst = worst
        self.k_max = k_max
        super().__init__(
            f"{n_over} row(s) exceed k_max={k_max} (worst row has "
            f"{worst} nnz): truncation would silently drop entries — "
            f"raise k_max, use the CSR/COO path, or pass "
            f"on_overflow='truncate' to accept the loss")


def csr_to_ell(row_ptr, cols, vals, n_rows: int, k_max: int,
               on_overflow: str = "raise"):
    """Host-side CSR→ELL pack (pad to k_max nnz per row) — fully
    vectorized scatter, no Python row loop.  Returns numpy
    ``(ecols int32 (n_rows, k_max), evals float32 (n_rows, k_max))``.

    Rows with more than ``k_max`` entries cannot be represented: the
    default ``on_overflow='raise'`` surfaces :class:`EllOverflowError`
    instead of silently truncating; ``'truncate'`` keeps the first
    ``k_max`` entries per row (explicit lossy opt-in).
    """
    if on_overflow not in ("raise", "truncate"):
        raise ValueError(f"on_overflow must be 'raise' or 'truncate', "
                         f"got {on_overflow!r}")
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    counts = np.diff(row_ptr)
    if on_overflow == "raise" and counts.size and counts.max() > k_max:
        over = counts > k_max
        raise EllOverflowError(int(over.sum()), int(counts.max()), k_max)
    ecols = np.full((n_rows, k_max), -1, np.int32)
    evals = np.zeros((n_rows, k_max), np.float32)
    keep = np.minimum(counts, k_max)
    total = int(keep.sum())
    if total:
        rows = np.repeat(np.arange(n_rows), keep)
        offs = np.arange(total) - np.repeat(np.cumsum(keep) - keep, keep)
        src = np.repeat(row_ptr[:-1], keep) + offs
        ecols[rows, offs] = cols[src]
        evals[rows, offs] = vals[src]
    return ecols, evals


def check_ell(ecols: torch.Tensor, evals: torch.Tensor) -> None:
    """Validate an ELL pack: int32 cols and float32 vals of one 2-D shape,
    both contiguous."""
    if ecols.dtype != torch.int32 or evals.dtype != torch.float32:
        raise TypeError(f"ELL pack must be (int32, float32), got "
                        f"({ecols.dtype}, {evals.dtype})")
    if ecols.dim() != 2 or ecols.shape != evals.shape:
        raise ValueError(f"ecols/evals must share one (R, K) shape, got "
                         f"{tuple(ecols.shape)} and {tuple(evals.shape)}")
    if not (ecols.is_contiguous() and evals.is_contiguous()):
        raise ValueError("ecols/evals must be contiguous")


def spmv_ell(ecols: torch.Tensor, evals: torch.Tensor, x: torch.Tensor,
             ring: str = "plus_times") -> torch.Tensor:
    """y = A ⊕.⊗ x with A in ELL (n_rows, k_max): int32 cols, float32
    vals, float32 ``x`` (n_cols,) → float32 (n_rows,)."""
    if ring not in RINGS:
        raise ValueError(f"ring must be one of {RINGS}, got {ring!r}")
    check_ell(ecols, evals)
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 (n_cols,), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not ops.on_cuda(ecols, evals, x):
        return spmv_ell_ref(ecols, evals, x, ring)
    n_rows, k = ecols.shape
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if n_rows:
        ops.launch("ell", "ell_spmv", "spmv_ell", x.device,
                   ecols.data_ptr(), evals.data_ptr(), x.data_ptr(),
                   y.data_ptr(), n_rows, k, x.shape[0], RINGS.index(ring))
    return y
