"""ELL-format semiring SpMM — the batched analytics unit.

``spmv_ell`` answers ONE query per launch; :func:`spmm_ell` multiplies
one ELL block against a dense multi-vector, ``Y (n, b) = A ⊕.⊗ X
(n_cols, b)``, so ``eval_batch`` answers ``b`` matvec chains with one
launch per factor.  Same conventions as ``spmv_ell``: the max_times
accumulator starts at -inf, padding slots (``col == -1``) are skipped,
rows with no entries resolve to 0, and ``b == 1`` equals ``spmv_ell``.
"""
from __future__ import annotations

import torch

from . import ops
from .ref import RINGS, spmm_ell_ref
from .spmv import check_ell


def spmm_ell(ecols: torch.Tensor, evals: torch.Tensor, x: torch.Tensor,
             ring: str = "plus_times") -> torch.Tensor:
    """``Y = A ⊕.⊗ X`` with A in ELL (n_rows, k_max), X dense float32
    (n_cols, b) → float32 (n_rows, b)."""
    if ring not in RINGS:
        raise ValueError(f"ring must be one of {RINGS}, got {ring!r}")
    if x.dim() != 2:
        raise ValueError(f"X must be (n_cols, b), got shape {tuple(x.shape)}")
    check_ell(ecols, evals)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"X must be contiguous float32, got {x.dtype}")
    if not ops.on_cuda(ecols, evals, x):
        return spmm_ell_ref(ecols, evals, x, ring)
    n_rows, k = ecols.shape
    n_cols, b = x.shape
    y = torch.empty((n_rows, b), dtype=torch.float32, device=x.device)
    if n_rows and b:
        ops.launch("ell", "ell_spmm", "spmm_ell", x.device,
                   ecols.data_ptr(), evals.data_ptr(), x.data_ptr(),
                   y.data_ptr(), n_rows, k, n_cols, b, RINGS.index(ring))
    return y
