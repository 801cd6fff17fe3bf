"""Device-side sparse payloads for associative arrays.

Two representations, plain dataclasses of torch tensors:

* :class:`COO` — sorted coordinate triples. The construction format; all
  Assoc payloads normalize to row-major sorted, coalesced COO.
* :class:`CSR` — compressed rows.

Host construction (numpy) produces exact-size buffers.  The in-place
:func:`coalesce` keeps its buffer size and parks dead entries at
``row == nrows`` (sorted past the end, value 0), the layout the JAX
reference uses under static shapes; every segment reduction here drops
such ids (see :func:`repro_torch.core.semiring.segment_reduce`).

Tensors made from host arrays follow the reference's 32-bit device
convention: float64 values land as float32 and int64 as int32.

The degree computation / SpMV here are the numeric heart of the paper:
stage 6 builds ``TedgeDeg`` with exactly :func:`row_degree` /
:func:`col_degree`, and every analytic (power-law background, PageRank)
is a semiring SpMV over the incidence/adjacency payload.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import get_device
from . import semiring as sr

Tensor = torch.Tensor


def to_device(a, dtype: Optional[torch.dtype] = None) -> Tensor:
    """Host array → tensor on the current device, 64-bit narrowed to 32."""
    t = torch.as_tensor(np.asarray(a))
    if dtype is None:
        dtype = {torch.float64: torch.float32,
                 torch.int64: torch.int32}.get(t.dtype, t.dtype)
    return t.to(device=get_device(), dtype=dtype)


@dataclasses.dataclass
class COO:
    """Sorted, coalesced coordinate-format sparse matrix."""

    rows: Tensor            # int32[nnz]   (row-major sorted)
    cols: Tensor            # int32[nnz]
    vals: Tensor            # dtype[nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def astype(self, dtype) -> "COO":
        return COO(self.rows, self.cols, self.vals.to(dtype), self.shape)

    @classmethod
    def from_numpy(cls, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   shape: Tuple[int, int]) -> "COO":
        """Build from host triples: sort + coalesce (exact nnz) on host."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if rows.size:
            # coalesce duplicates by summation (plus_times construction).
            key = rows * shape[1] + cols
            uniq, inv = np.unique(key, return_inverse=True)
            out = np.zeros(uniq.shape[0], dtype=vals.dtype)
            np.add.at(out, inv, vals)
            rows = (uniq // shape[1]).astype(np.int32)
            cols = (uniq % shape[1]).astype(np.int32)
            vals = out
        return cls(to_device(rows, torch.int32), to_device(cols, torch.int32),
                   to_device(vals), shape)

    def to_dense(self) -> Tensor:
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.vals.device)
        out.index_put_((self.rows.long(), self.cols.long()), self.vals,
                       accumulate=True)
        return out

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.coo_matrix(
            (self.vals.cpu().numpy(),
             (self.rows.cpu().numpy(), self.cols.cpu().numpy())),
            shape=self.shape).tocsr()


@dataclasses.dataclass
class CSR:
    """Compressed-sparse-row payload."""

    row_ptr: Tensor          # int32[nrows+1]
    cols: Tensor             # int32[nnz]
    vals: Tensor             # dtype[nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])


def coo_to_csr(m: COO) -> CSR:
    counts = sr.segment_reduce(torch.ones_like(m.rows), m.rows, m.shape[0],
                               "sum")
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=m.device),
                         torch.cumsum(counts, 0).to(torch.int32)])
    return CSR(row_ptr, m.cols, m.vals, m.shape)


def csr_to_coo(m: CSR) -> COO:
    pos = torch.arange(m.nnz, dtype=torch.int32, device=m.cols.device)
    rows = torch.searchsorted(m.row_ptr, pos, right=True).to(torch.int32) - 1
    return COO(rows, m.cols, m.vals, m.shape)


# ---------------------------------------------------------------------------
# Core semiring contractions (used by the device analytics).
# ---------------------------------------------------------------------------

def spmv(m: COO, x: Tensor, ring: "sr.Semiring | str" = sr.PLUS_TIMES) -> Tensor:
    """y[i] = ⊕_j m[i,j] ⊗ x[j]  — generic semiring mat-vec."""
    ring = sr.get(ring)
    prods = ring.mul(m.vals, x[m.cols.long()])
    return ring.reduce(prods, m.rows, m.shape[0])


def spmv_t(m: COO, x: Tensor, ring: "sr.Semiring | str" = sr.PLUS_TIMES) -> Tensor:
    """y[j] = ⊕_i m[i,j] ⊗ x[i]  — transpose mat-vec without re-sorting.

    Dead slots (``row == nrows``) read ``x`` at the clamped last index,
    as the reference's gather does; :func:`coalesce` gives them value 0."""
    ring = sr.get(ring)
    safe = torch.clamp(m.rows.long(), max=max(m.shape[0] - 1, 0))
    prods = ring.mul(m.vals, x[safe])
    return ring.reduce(prods, m.cols, m.shape[1])


def spmm(m: COO, x: Tensor, ring: "sr.Semiring | str" = sr.PLUS_TIMES) -> Tensor:
    """(nr, nc) sparse @ (nc, k) dense → (nr, k) dense, generic semiring."""
    ring = sr.get(ring)
    prods = ring.mul(m.vals[:, None], x[m.cols.long()])   # (nnz, k)
    return ring.reduce(prods, m.rows, m.shape[0])


def row_degree(m: COO, weighted: bool = False) -> Tensor:
    """Out-degree per row — the ``sum(E, 2)`` of the paper's stage 6."""
    w = m.vals if weighted else torch.ones_like(m.vals)
    return sr.segment_reduce(w, m.rows, m.shape[0], "sum")


def col_degree(m: COO, weighted: bool = False) -> Tensor:
    """In-degree per column — the ``sum(E, 1)`` building ``TedgeDeg``."""
    w = m.vals if weighted else torch.ones_like(m.vals)
    return sr.segment_reduce(w, m.cols, m.shape[1], "sum")


def transpose(m: COO) -> COO:
    key = m.cols.long() * (m.shape[0] + 1) + m.rows.long()
    order = torch.argsort(key, stable=True)
    return COO(m.cols[order], m.rows[order], m.vals[order],
               (m.shape[1], m.shape[0]))


def _coalesce_fixed(rows: Tensor, cols: Tensor, vals: Tensor, num_rows: int):
    """Coalesce that keeps nnz, sums duplicates, parks dead slots at end.

    Dead slots get ``row == num_rows`` so a subsequent segment reduce with
    ``num_segments == num_rows`` drops them.
    """
    n = rows.shape[0]
    ncols_key = cols.max().long() + 1
    key = rows.long() * ncols_key + cols.long()
    order = torch.argsort(key, stable=True)
    key, vals = key[order], vals[order]
    head = torch.ones(n, dtype=torch.bool, device=key.device)
    head[1:] = key[1:] != key[:-1]
    # Position of each run head; duplicates accumulate into the head slot.
    seg = torch.cumsum(head, 0) - 1
    summed = sr.segment_reduce(vals, seg, n, "sum")
    n_unique = int(head.sum())
    idx = torch.arange(n, device=key.device)
    live = idx < n_unique
    head_pos = torch.full((n,), n - 1, dtype=torch.long, device=key.device)
    head_pos[:n_unique] = torch.nonzero(head).flatten()
    out_key = torch.where(live, key[head_pos], -1)
    out_val = torch.where(live, summed, torch.zeros_like(summed))
    out_rows = torch.where(live, (out_key // ncols_key).to(torch.int32),
                           num_rows)
    out_cols = torch.where(live, (out_key % ncols_key).to(torch.int32), 0)
    return out_rows.to(torch.int32), out_cols.to(torch.int32), out_val


def coalesce(m: COO) -> COO:
    """Fixed-nnz coalesce (dead entries parked at row == nrows)."""
    r, c, v = _coalesce_fixed(m.rows, m.cols, m.vals, m.shape[0])
    return COO(r, c, v, m.shape)


# ---------------------------------------------------------------------------
# Host-side exact algebra (scipy bridge) — used by Assoc, mirrors how D4M
# delegates to MATLAB's sparse engine.  Device analytics never touch this.
# ---------------------------------------------------------------------------

def scipy_from_triples(rows, cols, vals, shape):
    import scipy.sparse as sp
    return sp.csr_matrix(
        (np.asarray(vals, dtype=np.float64),
         (np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64))),
        shape=shape)


def coo_from_scipy(m, dtype: Optional[torch.dtype] = None) -> COO:
    """Row-major sorted device COO of a scipy matrix (values in
    ``dtype``, float32 for float64 input when omitted)."""
    m = m.tocoo()
    order = np.lexsort((m.col, m.row))
    return COO(to_device(m.row[order], torch.int32),
               to_device(m.col[order], torch.int32),
               to_device(m.data[order], dtype), m.shape)
