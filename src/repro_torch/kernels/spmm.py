"""ELL-format semiring SpMM — the batched analytics unit.

``spmv_ell`` answers ONE query per launch; :func:`spmm_ell` multiplies
one ELL block against a dense multi-vector, ``Y (n, b) = A ⊕.⊗ X
(n_cols, b)``, so ``eval_batch`` answers ``b`` matvec chains with one
launch per factor.  Same conventions as ``spmv_ell``: the max_times
accumulator starts at -inf, padding slots (``col == -1``) are skipped,
rows with no entries resolve to 0, and ``b == 1`` equals ``spmv_ell``.
:func:`spgemm_sel` answers ``b`` column selects of the same block in one
launch without building the one-hot X.
"""
from __future__ import annotations

import torch

from . import ops
from .ref import RINGS, spgemm_sel_ref, spmm_ell_ref
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


def spgemm_sel(ecols: torch.Tensor, evals: torch.Tensor, sel: torch.Tensor,
               ring: str = "plus_times") -> torch.Tensor:
    """``Y[r, j] = A[r, sel[j]]`` under the semiring — the masked SpGEMM
    answering a batch of column queries in one launch: A in ELL
    (n_rows, k_max), ``sel`` the (b,) integer column ids (used as int32)
    → float32 (n_rows, b).

    Only stored slots whose column equals ``sel[j]`` reduce.  Equal to
    :func:`spmm_ell` against the dense one-hot X under plus_times; under
    max_times a dense zero never clamps a negative maximum, as it would
    in the one-hot product (GraphBLAS sparse semantics)."""
    if ring not in RINGS:
        raise ValueError(f"ring must be one of {RINGS}, got {ring!r}")
    check_ell(ecols, evals)
    if sel.dim() != 1 or sel.dtype.is_floating_point or \
            sel.dtype.is_complex or sel.dtype == torch.bool:
        raise ValueError(f"sel must be a 1-D integer tensor, got {sel.dtype} "
                         f"{tuple(sel.shape)}")
    if not ops.on_cuda(ecols, evals, sel):
        return spgemm_sel_ref(ecols, evals, sel, ring)
    sel = sel.to(torch.int32).contiguous()
    n_rows, k = ecols.shape
    b = sel.shape[0]
    y = torch.empty((n_rows, b), dtype=torch.float32, device=evals.device)
    if n_rows and b:
        ops.launch("ell", "ell_spgemm_sel", "spgemm_sel", evals.device,
                   ecols.data_ptr(), evals.data_ptr(), sel.data_ptr(),
                   y.data_ptr(), n_rows, k, b, RINGS.index(ring))
    return y
