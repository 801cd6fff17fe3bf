"""Associative arrays — the paper's central mathematical object.

An :class:`Assoc` is a sparse matrix whose rows and columns are indexed by
sorted string keys and whose values live in a semiring; it unifies
spreadsheets, SQL/NoSQL tables, and sparse linear algebra (paper §II-B,
Fig. 2).  This implementation mirrors the documented D4M (MATLAB/Julia)
surface: triple construction, key-aligned algebra (+, elementwise *,
semiring matmul), sub-array selection by key lists / ranges / prefixes,
``val2col`` schema explosion, and ``putval``/``putcol`` renaming used by
the paper's ingest step.

Host/device split: key dictionaries and exact-size algebra live on the
host (numpy + scipy sparse, the same role MATLAB's sparse engine plays
for D4M), while the numeric payload exports to
:class:`repro_torch.core.sparse.COO` — torch tensors on
:func:`repro_torch.device.get_device` — for the device analytics.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

from . import keys as K
from . import sparse as S

_AGGS = {
    "sum": lambda out, inv, vals: np.add.at(out, inv, vals),
    "min": lambda out, inv, vals: np.minimum.at(out, inv, vals),
    "max": lambda out, inv, vals: np.maximum.at(out, inv, vals),
}


def _agg_numeric(inv: np.ndarray, vals: np.ndarray, n: int, agg: str):
    if agg == "first":
        out = np.zeros(n, dtype=np.float64)
        # reversed so that the first occurrence wins
        out[inv[::-1]] = vals[::-1]
        return out
    if agg == "last":
        out = np.zeros(n, dtype=np.float64)
        out[inv] = vals
        return out
    init = {"sum": 0.0, "min": np.inf, "max": -np.inf}[agg]
    out = np.full(n, init, dtype=np.float64)
    _AGGS[agg](out, inv, vals.astype(np.float64))
    return out


class Assoc:
    """D4M associative array.

    Parameters mimic D4M's triple constructor::

        A = Assoc('r1,r2,', 'c1,c2,', [1.0, 2.0])
        A = Assoc(rows, cols, 'v1,v2,')          # string values (categorical)

    Duplicate (row, col) pairs collide via ``agg`` (default: numeric sum,
    string lexicographic min — D4M's documented behaviour).
    """

    __slots__ = ("row", "col", "val", "sm")

    def __init__(self, row=None, col=None, val=None, agg: str = None,
                 _parts=None):
        if _parts is not None:  # internal fast path
            self.row, self.col, self.val, self.sm = _parts
            return
        if row is None:  # empty
            import scipy.sparse as sp
            self.row = np.empty((0,), dtype="U1")
            self.col = np.empty((0,), dtype="U1")
            self.val = None
            self.sm = sp.csr_matrix((0, 0))
            return

        rkeys = K.parse_keys(row)
        ckeys = K.parse_keys(col)
        if isinstance(val, (int, float)):
            val = np.full(max(rkeys.shape[0], ckeys.shape[0]), val)
        vraw = val

        # broadcast singleton key lists against the longest input
        n = max(rkeys.shape[0], ckeys.shape[0],
                len(vraw) if hasattr(vraw, "__len__") and not isinstance(vraw, str)
                else K.parse_keys(vraw).shape[0] if isinstance(vraw, str) else 0)
        if rkeys.shape[0] == 1 and n > 1:
            rkeys = np.repeat(rkeys, n)
        if ckeys.shape[0] == 1 and n > 1:
            ckeys = np.repeat(ckeys, n)

        categorical = False
        if isinstance(vraw, str) or (
                isinstance(vraw, np.ndarray) and vraw.dtype.kind in "US") or (
                isinstance(vraw, (list, tuple)) and len(vraw) and
                isinstance(vraw[0], (str, bytes))):
            vkeys = K.parse_keys(vraw)
            if vkeys.shape[0] == 1 and n > 1:
                vkeys = np.repeat(vkeys, n)
            categorical = True
            vals_arr = vkeys
        else:
            vals_arr = np.asarray(vraw, dtype=np.float64)
            if vals_arr.ndim == 0:
                vals_arr = np.repeat(vals_arr[None], n)

        if not (rkeys.shape[0] == ckeys.shape[0] == vals_arr.shape[0]):
            raise ValueError(
                f"triple lengths differ: rows={rkeys.shape[0]} "
                f"cols={ckeys.shape[0]} vals={vals_arr.shape[0]}")

        self.row, ri = np.unique(rkeys, return_inverse=True)
        self.col, ci = np.unique(ckeys, return_inverse=True)

        import scipy.sparse as sp
        nr, nc = self.row.shape[0], self.col.shape[0]
        if rkeys.shape[0] == 0:
            self.val = None
            self.sm = sp.csr_matrix((nr, nc))
            return

        lin = ri.astype(np.int64) * nc + ci.astype(np.int64)
        uniq, inv = np.unique(lin, return_inverse=True)

        if categorical:
            agg = agg or "min"
            # collide string values by lexicographic agg, then build the
            # value dictionary; payload stores 1-based dictionary indices.
            order = np.argsort(vals_arr) if agg == "min" else \
                np.argsort(vals_arr)[::-1]
            chosen = np.empty(uniq.shape[0], dtype=vals_arr.dtype)
            # reversed write ⇒ smallest (agg=min) value wins per slot
            chosen[inv[order][::-1]] = vals_arr[order][::-1]
            self.val, vidx = np.unique(chosen, return_inverse=True)
            data = vidx.astype(np.float64) + 1.0
        else:
            agg = agg or "sum"
            self.val = None
            data = _agg_numeric(inv, vals_arr, uniq.shape[0], agg)

        r = (uniq // nc).astype(np.int64)
        c = (uniq % nc).astype(np.int64)
        self.sm = sp.csr_matrix((data, (r, c)), shape=(nr, nc))
        self.sm.eliminate_zeros()
        self._compact()

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    @classmethod
    def _from_parts(cls, row, col, val, sm) -> "Assoc":
        a = cls(_parts=(np.asarray(row, dtype=str), np.asarray(col, dtype=str),
                        None if val is None else np.asarray(val, dtype=str),
                        sm.tocsr()))
        return a

    def _compact(self) -> "Assoc":
        """Drop rows/cols with no entries (D4M condenses key sets)."""
        self.sm.eliminate_zeros()
        coo = self.sm.tocoo()
        rmask = np.zeros(self.sm.shape[0], bool)
        rmask[coo.row] = True
        cmask = np.zeros(self.sm.shape[1], bool)
        cmask[coo.col] = True
        if rmask.all() and cmask.all():
            return self
        self.row = self.row[rmask]
        self.col = self.col[cmask]
        self.sm = self.sm[rmask][:, cmask].tocsr()
        return self

    def _numeric_sm(self):
        """Numeric view: categorical arrays are viewed as logical (D4M)."""
        if self.val is None:
            return self.sm
        out = self.sm.copy()
        out.data = np.ones_like(out.data)
        return out

    # ------------------------------------------------------------------
    # basics
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return self.sm.shape

    @property
    def nnz(self) -> int:
        return int(self.sm.nnz)

    def triples(self):
        """Return (row_keys, col_keys, values) triple arrays (D4M find)."""
        coo = self.sm.tocoo()
        order = np.lexsort((coo.col, coo.row))
        r, c, d = coo.row[order], coo.col[order], coo.data[order]
        vals = (self.val[(d - 1).astype(np.int64)]
                if self.val is not None else d)
        return self.row[r], self.col[c], vals

    def getval(self):
        return self.triples()[2]

    def __len__(self):
        return self.nnz

    def __bool__(self):
        return self.nnz > 0

    def copy(self) -> "Assoc":
        return Assoc._from_parts(self.row.copy(), self.col.copy(),
                                 None if self.val is None else self.val.copy(),
                                 self.sm.copy())

    # ------------------------------------------------------------------
    # selection
    # ------------------------------------------------------------------
    def __getitem__(self, idx) -> "Assoc":
        rsel, csel = idx if isinstance(idx, tuple) else (idx, All())
        ri = K.resolve_selector(rsel, self.row)
        ci = K.resolve_selector(csel, self.col)
        sub = self.sm[ri][:, ci].tocsr()
        out = Assoc._from_parts(self.row[ri], self.col[ci], self.val, sub)
        return out._compact()

    def row_select(self, sel) -> "Assoc":
        return self[sel, All()]

    def col_select(self, sel) -> "Assoc":
        return self[All(), sel]

    # ------------------------------------------------------------------
    # algebra
    # ------------------------------------------------------------------
    def _onto(self, rmap, cmap, shape, sm=None):
        """Project a payload over this array's keys (``sm``, the numeric
        payload by default) onto aligned key dictionaries of ``shape``
        through the maps :func:`keys.align` returns: the position there
        of each of this array's row (column) keys, -1 where absent, or
        None where the dictionary is this array's own.  Entries on an
        absent key are dropped, the rest re-indexed; the result is a
        canonical CSR (sorted indices, no duplicates).  With both maps
        None it is the payload itself: do not modify it."""
        import scipy.sparse as sp

        if sm is None:
            sm = self._numeric_sm()
        if rmap is None and cmap is None:
            if not sm.has_canonical_format:
                sm = sm.copy()
                sm.sum_duplicates()
            return sm
        rows = np.repeat(np.arange(sm.shape[0]) if rmap is None else rmap,
                         np.diff(sm.indptr))
        cols = sm.indices if cmap is None else cmap[sm.indices]
        keep = (rows >= 0) & (cols >= 0)
        rows = rows[keep]
        indptr = np.zeros(shape[0] + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=shape[0]), out=indptr[1:])
        # the maps are increasing, so entries stay in row-major order
        out = sp.csr_matrix((sm.data[keep], cols[keep], indptr), shape=shape)
        out.sum_duplicates()    # a no-op on a canonical input
        return out

    def _aligned(self, other: "Assoc", how: str):
        """Row and column keys of both arrays intersected (``"inter"``)
        or united (``"union"``), and both payloads projected onto them."""
        r = K.align(self.row, other.row, how)
        c = K.align(self.col, other.col, how)
        shape = (r.keys.shape[0], c.keys.shape[0])
        return (r.keys, c.keys, self._onto(r.ia, c.ia, shape),
                other._onto(r.ib, c.ib, shape))

    def _inner_aligned(self, other: "Assoc"):
        """The payloads of ``self @ other`` over the inner dimension D4M
        uses, ``self.col`` ∩ ``other.row``, and that alignment."""
        inner = K.align(self.col, other.row, "inter")
        k = inner.keys.shape[0]
        return (self._onto(None, inner.ia, (self.row.shape[0], k)),
                other._onto(inner.ib, None, (k, other.col.shape[0])), inner)

    def __add__(self, other) -> "Assoc":
        if isinstance(other, (int, float)):
            out = self.copy()
            out.sm.data = out._numeric_sm().data + other
            out.val = None
            return out
        if self.val is not None and other.val is not None:
            return self._categorical_add(other)
        if self.val is not None or other.val is not None:
            # categorical union-add: collide via lexicographic min, the
            # numeric side's values compared as strings
            r1, c1, v1 = self.triples()
            r2, c2, v2 = other.triples()
            return Assoc(np.concatenate([r1, r2]), np.concatenate([c1, c2]),
                         np.concatenate([v1.astype(str), v2.astype(str)]),
                         agg="min")
        row, col, a, b = self._aligned(other, "union")
        return Assoc._from_parts(row, col, None, a + b)._compact()

    def _categorical_add(self, other: "Assoc") -> "Assoc":
        """Union-add of two categorical arrays: where both hold an entry
        the lexicographically smaller string wins, as D4M collides."""
        r = K.align(self.row, other.row, "union")
        c = K.align(self.col, other.col, "union")
        v = K.align(self.val, other.val, "union")
        shape = (r.keys.shape[0], c.keys.shape[0])
        top = v.keys.shape[0] + 1

        def ranked(x: "Assoc", vmap):
            # value k (1-based in v.keys) becomes top - k, so the union's
            # elementwise maximum keeps the smaller string
            sm = x.sm.copy()
            k = sm.data if vmap is None else \
                vmap[sm.data.astype(np.int64) - 1] + 1.0
            sm.data = top - k
            return sm

        sm = self._onto(r.ia, c.ia, shape, ranked(self, v.ia)).maximum(
            other._onto(r.ib, c.ib, shape, ranked(other, v.ib)))
        won = (top - sm.data).astype(np.int64)
        used = np.zeros(top, bool)
        used[won] = True
        # renumber over the values that won, as the triple build does
        sm.data = np.cumsum(used)[won].astype(np.float64)
        val = v.keys[used[1:]] if sm.nnz else None
        return Assoc._from_parts(r.keys, c.keys, val, sm)._compact()

    def __sub__(self, other) -> "Assoc":
        row, col, a, b = self._aligned(other, "union")
        return Assoc._from_parts(row, col, None, a - b)._compact()

    def multiply(self, other: "Assoc") -> "Assoc":
        """Element-wise (Hadamard) product on intersected keys."""
        row, col, a, b = self._aligned(other, "inter")
        return Assoc._from_parts(row, col, None, a.multiply(b))._compact()

    def __and__(self, other) -> "Assoc":
        return self.logical().multiply(other.logical())

    def __or__(self, other) -> "Assoc":
        return (self.logical() + other.logical()).logical()

    def __mul__(self, other) -> "Assoc":
        """Semiring (+.*) array multiply with key-aligned inner dimension.

        D4M aligns the inner dimension by key *intersection*: only columns
        of A that are also rows of B contribute (paper Fig. 2 semantics).
        """
        if isinstance(other, (int, float)):
            out = self.copy()
            out.sm = out._numeric_sm() * other
            out.val = None
            return out
        a, b, _ = self._inner_aligned(other)
        return Assoc._from_parts(self.row, other.col, None, a @ b)._compact()

    __rmul__ = __mul__

    def sqin(self) -> "Assoc":
        """A' * A — column-key correlation (graph from incidence: who
        shares a packet). The paper's adjacency construction."""
        return self.transpose() * self

    def sqout(self) -> "Assoc":
        """A * A' — row-key correlation."""
        return self * self.transpose()

    def transpose(self) -> "Assoc":
        return Assoc._from_parts(self.col, self.row, self.val,
                                 self.sm.T.tocsr())

    @property
    def T(self) -> "Assoc":
        return self.transpose()

    def sum(self, axis: int) -> "Assoc":
        """Semiring row/col sums. axis=1 sums across columns (out-degree);
        axis=0 down rows (in-degree) — `sum(E,1)` / `sum(E,2)` of stage 6."""
        m = self._numeric_sm()
        if axis in (1, 2):  # accept MATLAB's 2 for "across columns"
            v = np.asarray(m.sum(axis=1)).ravel()
            keep = v != 0
            return Assoc._from_parts(self.row[keep], np.asarray([""]), None,
                                     S.scipy_from_triples(
                                         np.arange(keep.sum()),
                                         np.zeros(keep.sum(), np.int64),
                                         v[keep], (int(keep.sum()), 1)))
        v = np.asarray(m.sum(axis=0)).ravel()
        keep = v != 0
        return Assoc._from_parts(np.asarray([""]), self.col[keep], None,
                                 S.scipy_from_triples(
                                     np.zeros(keep.sum(), np.int64),
                                     np.arange(keep.sum()),
                                     v[keep], (1, int(keep.sum()))))

    def logical(self) -> "Assoc":
        """spones — every stored entry becomes numeric 1."""
        out = self._numeric_sm().copy()
        out.data = np.ones_like(out.data)
        return Assoc._from_parts(self.row, self.col, None, out)

    # comparison filters (D4M: A > 5 keeps passing entries)
    def _filter(self, pred: Callable[[np.ndarray], np.ndarray]) -> "Assoc":
        r, c, v = self.triples()
        if self.val is None:
            m = pred(v)
        else:
            m = pred(v.astype(str))
        return Assoc(r[m], c[m], v[m]) if m.any() else Assoc()

    def __gt__(self, x):
        return self._filter(lambda v: v > x)

    def __ge__(self, x):
        return self._filter(lambda v: v >= x)

    def __lt__(self, x):
        return self._filter(lambda v: v < x)

    def __le__(self, x):
        return self._filter(lambda v: v <= x)

    def __eq__(self, x):  # noqa: D105 — D4M filter semantics, not identity
        if isinstance(x, Assoc):
            return (self.nnz == x.nnz and np.array_equal(self.row, x.row)
                    and np.array_equal(self.col, x.col)
                    and np.array_equal(np.asarray(self.triples()[2], dtype=str),
                                       np.asarray(x.triples()[2], dtype=str)))
        return self._filter(lambda v: v == x)

    __hash__ = None

    # ------------------------------------------------------------------
    # value/key rewriting (paper's ingest idioms)
    # ------------------------------------------------------------------
    def putval(self, val) -> "Assoc":
        """Overwrite every stored value — `putVal(E,'1,')` of stage 6."""
        r, c, _ = self.triples()
        vv = K.parse_keys(val)
        if vv.shape[0] == 1:
            vv = np.repeat(vv, r.shape[0])
        return Assoc(r, c, vv)

    def putcol(self, col) -> "Assoc":
        """Overwrite column keys — `putCol(sum(E',2),'degree,')`."""
        r, _, v = self.triples()
        cc = K.parse_keys(col)
        if cc.shape[0] == 1:
            cc = np.repeat(cc, r.shape[0])
        return Assoc(r, cc, v)

    def putrow(self, row) -> "Assoc":
        _, c, v = self.triples()
        rr = K.parse_keys(row)
        if rr.shape[0] == 1:
            rr = np.repeat(rr, c.shape[0])
        return Assoc(rr, c, v)

    def num2str(self) -> "Assoc":
        """Numeric → categorical string values (paper: num2str(Edeg))."""
        r, c, v = self.triples()
        sv = np.asarray([f"{x:g}" for x in np.asarray(v, dtype=np.float64)],
                        dtype=str)
        return Assoc(r, c, sv)

    def str2num(self) -> "Assoc":
        r, c, v = self.triples()
        return Assoc(r, c, np.asarray(v, dtype=np.float64))

    # ------------------------------------------------------------------
    # schema ops (delegates; see repro_torch.core.schema)
    # ------------------------------------------------------------------
    def val2col(self, sep: str = "|") -> "Assoc":
        from . import schema
        return schema.val2col(self, sep)

    def col2val(self, sep: str = "|") -> "Assoc":
        from . import schema
        return schema.col2val(self, sep)

    # ------------------------------------------------------------------
    # deferred algebra bridge
    # ------------------------------------------------------------------
    def lazy(self) -> "LazyAssoc":
        """Wrap into a deferred expression (see :mod:`repro_torch.core.expr`):
        subsequent algebra builds an operator DAG that a planner fuses
        and executes in one pass."""
        from .expr import LazyAssoc
        return LazyAssoc.leaf(self)

    # ------------------------------------------------------------------
    # device bridge
    # ------------------------------------------------------------------
    def device_coo(self, dtype=None) -> S.COO:
        """Export the numeric payload as a torch COO on the device
        (:func:`repro_torch.device.get_device`); ``dtype`` is a torch
        dtype, float32 when omitted."""
        return S.coo_from_scipy(self._numeric_sm(), dtype=dtype)

    # ------------------------------------------------------------------
    # io / display
    # ------------------------------------------------------------------
    def __repr__(self):
        r, c, v = self.triples()
        lines = [f"Assoc {self.shape[0]}x{self.shape[1]} nnz={self.nnz}"
                 + (" (categorical)" if self.val is not None else "")]
        show = min(self.nnz, 12)
        for i in range(show):
            lines.append(f"  ({r[i]}, {c[i]})  {v[i]}")
        if self.nnz > show:
            lines.append(f"  ... {self.nnz - show} more")
        return "\n".join(lines)

    def save(self, path: str) -> None:
        """Atomic save (tmp + rename) — safe under the runner's
        speculative re-execution: concurrent writers of identical
        content cannot tear the file."""
        import os
        import threading
        r, c, v = self.triples()
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp.npz"
        np.savez_compressed(tmp, rows=r, cols=c,
                            vals=np.asarray(v),
                            categorical=self.val is not None)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Assoc":
        z = np.load(path, allow_pickle=False)
        vals = z["vals"]
        if z["categorical"]:
            vals = vals.astype(str)
        return cls(z["rows"].astype(str), z["cols"].astype(str), vals)


# convenience re-exports used all over the pipeline code
All = K.All
StartsWith = K.StartsWith
KeyRange = K.KeyRange
