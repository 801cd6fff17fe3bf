"""Deferred associative-array algebra — the lazy half of the D4M binding.

An Assoc expression like ``(T[r, :].logical() * T[r, :].logical().T) > k``
normally materializes a host Assoc per step: every ``logical()`` copies the
payload, every comparison rebuilds the array from string triples (unique +
re-sort of the key dictionaries), and a database table ``T`` is scanned once
per subscript.  :class:`LazyAssoc` instead records the chain as an operator
DAG and a small planner executes it in one pass:

* **selection pushdown** — subscripts migrate through transposes,
  elementwise ops, and matmuls down to the leaves, so a
  :class:`repro_torch.db.binding.DBTable` scan reads only the requested tablet
  range instead of the whole table;
* **common-subexpression elimination** — structurally identical subtrees
  (the two ``T[r, :]`` scans above) execute once;
* **elementwise fusion** — chains of ``logical`` / comparison / scalar ops
  apply as one masked pass over the csr payload, skipping the per-stage
  triple rebuild;
* **device lowering** — large-nnz reductions (``sum``) and vector-shaped
  semiring matmuls lower to the device instead of scipy on host.  Sums
  run :class:`repro_torch.core.sparse.COO` segment reductions; products
  run the hand-written ELL SpMV/SpMM kernels (:mod:`repro_torch.kernels`):
  CUDA on the card, their plain versions on CPU tensors.

Eager semantics are the specification: for every host-executed chain,
``lazy_chain.eval() == eager_chain`` (see tests/test_binding.py).  The
one licensed deviation is precision: device-lowered reductions (nnz ≥
``DEVICE_NNZ_THRESHOLD``) accumulate in float32, so
non-integer payloads match eager to ~1e-7 relative rather than exactly.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from . import keys as K
from . import sparse as S
from ..device import get_device
from ..kernels import spmm as kspmm
from ..kernels import spmv as kspmv
from ..obs.metrics import REGISTRY as _REGISTRY
from ..obs.trace import span as _span
from .assoc import Assoc

# nnz at which sums and products move to the device; small payloads stay
# on host where scipy beats dispatch+transfer overhead.  A sum tests its
# operand, a two-part product its aligned factor, a chain its largest
# factor.
DEVICE_NNZ_THRESHOLD = 32768

# Device launch odometer: every product _device_product sends to an ELL
# kernel bumps its counter (spmv for one vector, spmm for a block).  This
# is the observability hook the batch-fusion tests (and the serving
# layer's stats) use to prove N chains executed as ONE fused SpMM launch
# instead of N SpMV launches.  The counters
# are atomic registry counters (repro_torch.obs) — the old bare-dict version
# raced under the gateway's concurrent reader threads — and surface in
# /metrics as repro_kernel_launches_total{kernel=...}.
_KERNEL_LAUNCH_FAMILY = _REGISTRY.counter(
    "repro_kernel_launches_total", "Device-lowered kernel launches",
    labels=("kernel",))
_KERNEL_COUNTERS = {
    "spmv": _KERNEL_LAUNCH_FAMILY.labels(kernel="spmv"),
    "spmm": _KERNEL_LAUNCH_FAMILY.labels(kernel="spmm"),
}


def launch_counts() -> dict:
    """Snapshot of the device launch counters (copy — safe to diff)."""
    return {k: c.value for k, c in _KERNEL_COUNTERS.items()}


_FUSABLE = frozenset({"logical", "filter", "scale", "shift"})
_ELEMENTWISE_BIN = frozenset({"add", "sub", "emul"})

# the span each executed node records (a chain of _FUSABLE ops runs as
# one pass, so it records one "fused" span); leaves record nothing
_EXEC_SPANS = {op: f"planner.exec.{op}" for op in (
    "scan", "select", "transpose", "add", "sub", "emul", "matmul", "sum")}
_EXEC_SPANS.update(dict.fromkeys(_FUSABLE, "planner.exec.fused"))


def _is_all(sel) -> bool:
    """True when a selector denotes the full axis (D4M ':')."""
    return (sel is None or isinstance(sel, K.All)
            or (isinstance(sel, str) and sel == ":")
            or (isinstance(sel, slice) and sel == slice(None)))


def _is_positional(sel) -> bool:
    """Boolean-mask / integer-index selectors refer to *positions* in one
    specific key dictionary, so they cannot migrate through ops that
    change or compact dictionaries — they are pushdown barriers."""
    return isinstance(sel, np.ndarray) and sel.dtype.kind in "biu"


def _sel_key(sel) -> Any:
    """Hashable structural key for a selector (CSE + plan identity)."""
    if _is_all(sel):
        return ":"
    if isinstance(sel, (K.StartsWith, K.KeyRange)):
        return sel
    if isinstance(sel, str):
        return sel
    if isinstance(sel, np.ndarray):
        return ("arr",) + tuple(sel.tolist())
    if isinstance(sel, (list, tuple)):
        return ("seq",) + tuple(str(x) for x in sel)
    return repr(sel)


class LazyAssoc:
    """A node in a deferred Assoc-expression DAG.

    Mirrors the :class:`Assoc` operator surface; algebra builds the graph,
    and anything that needs concrete data (``triples``, ``row``, ``repr``,
    ``device_coo`` …) triggers :meth:`eval` and delegates.  Results are
    cached per node, so a DAG evaluates at most once.
    """

    __slots__ = ("op", "children", "args", "_value")

    def __init__(self, op: str, children: tuple = (), **args):
        self.op = op
        self.children = children
        self.args = args
        self._value: Optional[Assoc] = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def leaf(cls, a: Assoc) -> "LazyAssoc":
        return cls("leaf", assoc=a)

    @classmethod
    def scan(cls, table, rsel=None, csel=None) -> "LazyAssoc":
        """Deferred ``table[rsel, csel]`` over a DB table binding."""
        return cls("scan", table=table, rsel=rsel, csel=csel)

    @staticmethod
    def wrap(x) -> "LazyAssoc":
        if isinstance(x, LazyAssoc):
            return x
        if isinstance(x, Assoc):
            return LazyAssoc.leaf(x)
        # DBTable and friends expose .lazy() returning their full scan
        if hasattr(x, "lazy"):
            return x.lazy()
        raise TypeError(f"cannot defer {type(x)!r}")

    # -- deferred algebra (mirrors Assoc) ----------------------------------
    def __getitem__(self, idx) -> "LazyAssoc":
        rsel, csel = idx if isinstance(idx, tuple) else (idx, None)
        return LazyAssoc("select", (self,), rsel=rsel, csel=csel)

    def transpose(self) -> "LazyAssoc":
        return LazyAssoc("transpose", (self,))

    @property
    def T(self) -> "LazyAssoc":
        return self.transpose()

    def logical(self) -> "LazyAssoc":
        return LazyAssoc("logical", (self,))

    def multiply(self, other) -> "LazyAssoc":
        return LazyAssoc("emul", (self, LazyAssoc.wrap(other)))

    def __mul__(self, other) -> "LazyAssoc":
        if isinstance(other, (int, float)):
            return LazyAssoc("scale", (self,), k=float(other))
        return LazyAssoc("matmul", (self, LazyAssoc.wrap(other)))

    def __rmul__(self, other) -> "LazyAssoc":
        if isinstance(other, (int, float)):
            return LazyAssoc("scale", (self,), k=float(other))
        return LazyAssoc("matmul", (LazyAssoc.wrap(other), self))

    def __add__(self, other) -> "LazyAssoc":
        if isinstance(other, (int, float)):
            return LazyAssoc("shift", (self,), k=float(other))
        return LazyAssoc("add", (self, LazyAssoc.wrap(other)))

    def __sub__(self, other) -> "LazyAssoc":
        return LazyAssoc("sub", (self, LazyAssoc.wrap(other)))

    def __and__(self, other) -> "LazyAssoc":
        return self.logical().multiply(LazyAssoc.wrap(other).logical())

    def __or__(self, other) -> "LazyAssoc":
        return (self.logical() + LazyAssoc.wrap(other).logical()).logical()

    def sum(self, axis: int) -> "LazyAssoc":
        return LazyAssoc("sum", (self,), axis=axis)

    def sqin(self) -> "LazyAssoc":
        return self.T * self

    def sqout(self) -> "LazyAssoc":
        return self * self.T

    def _cmp(self, cmp: str, x) -> "LazyAssoc":
        return LazyAssoc("filter", (self,), cmp=cmp, x=x)

    def __gt__(self, x):
        return self._cmp("gt", x)

    def __ge__(self, x):
        return self._cmp("ge", x)

    def __lt__(self, x):
        return self._cmp("lt", x)

    def __le__(self, x):
        return self._cmp("le", x)

    def __eq__(self, x):  # noqa: D105 — D4M filter, like Assoc.__eq__
        if isinstance(x, (Assoc, LazyAssoc)):
            other = x.eval() if isinstance(x, LazyAssoc) else x
            return self.eval() == other
        return self._cmp("eq", x)

    __hash__ = None

    # -- forcing -----------------------------------------------------------
    def eval(self) -> Assoc:
        """Optimize and execute the DAG; cached per node."""
        if self._value is None:
            with _span("planner.eval", op=self.op):
                self._value = _Executor().run(_optimize(self))
        return self._value

    def __getattr__(self, name: str):
        # Fallback for everything Assoc-shaped that needs concrete data
        # (triples, row, col, nnz, shape, putval, device_coo, save, ...).
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.eval(), name)

    def __len__(self):
        return len(self.eval())

    def __bool__(self):
        return bool(self.eval())

    def __repr__(self):
        if self._value is not None:
            return f"LazyAssoc(evaluated)\n{self._value!r}"
        return f"LazyAssoc<{self._plan_str()}>"

    def _plan_str(self) -> str:
        if self.op == "leaf":
            a = self.args["assoc"]
            return f"leaf[{a.shape[0]}x{a.shape[1]}]"
        if self.op == "scan":
            return (f"scan({getattr(self.args['table'], 'name', '?')}, "
                    f"{_sel_key(self.args['rsel'])}, "
                    f"{_sel_key(self.args['csel'])})")
        inner = ", ".join(c._plan_str() for c in self.children)
        extra = {k: v for k, v in self.args.items()}
        return f"{self.op}({inner}{', ' + repr(extra) if extra else ''})"


def lazy(x) -> LazyAssoc:
    """Wrap an Assoc (or table binding) into a deferred expression."""
    return LazyAssoc.wrap(x)


# ---------------------------------------------------------------------------
# Planner: selection pushdown + structural identity.
# ---------------------------------------------------------------------------

_NOT_COMPOSABLE = object()


def _compose_sel(inner, outer):
    """Compose two selectors on one axis; only trivial (either side is
    ':') compositions fuse — anything else stays a nested select."""
    if _is_all(outer):
        return inner
    if _is_all(inner):
        return outer
    return _NOT_COMPOSABLE


def _optimize(node: LazyAssoc) -> LazyAssoc:
    """Bottom-up rewrite: push selections toward the leaves so DB scans
    read only the requested key ranges, and cancel double transposes."""
    kids = tuple(_optimize(c) for c in node.children)
    n = LazyAssoc(node.op, kids, **node.args) if kids != node.children \
        else node

    if n.op == "transpose" and n.children[0].op == "transpose":
        return n.children[0].children[0]

    if n.op != "select":
        return n
    rsel, csel = n.args["rsel"], n.args["csel"]
    if _is_all(rsel) and _is_all(csel):
        return n.children[0]
    if _is_positional(rsel) or _is_positional(csel):
        return n   # positional selectors bind to this node's dictionaries
    (child,) = n.children

    if child.op == "select":
        rr = _compose_sel(child.args["rsel"], rsel)
        cc = _compose_sel(child.args["csel"], csel)
        if rr is not _NOT_COMPOSABLE and cc is not _NOT_COMPOSABLE:
            return _optimize(LazyAssoc("select", child.children,
                                       rsel=rr, csel=cc))
    if child.op == "scan":
        rr = _compose_sel(child.args["rsel"], rsel)
        cc = _compose_sel(child.args["csel"], csel)
        if rr is not _NOT_COMPOSABLE and cc is not _NOT_COMPOSABLE:
            return LazyAssoc("scan", table=child.args["table"],
                             rsel=rr, csel=cc)
    if child.op == "transpose":
        return _optimize(LazyAssoc(
            "transpose",
            (LazyAssoc("select", child.children, rsel=csel, csel=rsel),)))
    if child.op in _FUSABLE:
        # unary elementwise ops commute with selection entrywise; push the
        # select below so it keeps sinking toward a scan
        return _optimize(LazyAssoc(
            child.op,
            (LazyAssoc("select", child.children, rsel=rsel, csel=csel),),
            **child.args))
    if child.op in _ELEMENTWISE_BIN:
        return _optimize(LazyAssoc(
            child.op,
            tuple(LazyAssoc("select", (gc,), rsel=rsel, csel=csel)
                  for gc in child.children)))
    if child.op == "matmul":
        a, b = child.children
        return _optimize(LazyAssoc("matmul", (
            LazyAssoc("select", (a,), rsel=rsel, csel=None),
            LazyAssoc("select", (b,), rsel=None, csel=csel))))
    return n


def _skey(node: LazyAssoc):
    """Structural key — identical subtrees share one execution (CSE)."""
    if node.op == "leaf":
        return ("leaf", id(node.args["assoc"]))
    if node.op == "scan":
        return ("scan", id(node.args["table"]),
                _sel_key(node.args["rsel"]), _sel_key(node.args["csel"]))
    args = tuple(sorted((k, _sel_key(v) if k in ("rsel", "csel") else v)
                        for k, v in node.args.items()))
    return (node.op, args, tuple(_skey(c) for c in node.children))


# ---------------------------------------------------------------------------
# Executor.
# ---------------------------------------------------------------------------

_CMPS = {
    "gt": lambda v, x: v > x, "ge": lambda v, x: v >= x,
    "lt": lambda v, x: v < x, "le": lambda v, x: v <= x,
    "eq": lambda v, x: v == x,
}


class _Executor:
    def __init__(self):
        self._memo: dict = {}

    def run(self, node: LazyAssoc) -> Assoc:
        if node._value is not None:
            # a subtree forced earlier (its own .eval, or a previous DAG
            # sharing this node) never re-executes — scans included
            return node._value
        key = _skey(node)
        out = self._memo.get(key)
        if out is None:
            out = self._exec(node)
            self._memo[key] = out
        node._value = out
        return out

    def _exec(self, node: LazyAssoc) -> Assoc:
        op = node.op
        if op == "leaf":
            return node.args["assoc"]
        name = _EXEC_SPANS.get(op)
        if name is None:
            raise ValueError(f"unknown op {op!r}")
        with _span(name) as sp:
            out = self._exec_op(node, sp)
            if sp.live:
                sp.tag(nnz=int(out.nnz), shape=list(out.shape))
        return out

    def _exec_op(self, node: LazyAssoc, sp) -> Assoc:
        op = node.op
        if op == "scan":
            return node.args["table"]._scan(node.args["rsel"],
                                            node.args["csel"])
        if op == "select":
            a = self.run(node.children[0])
            rsel = node.args["rsel"] if node.args["rsel"] is not None \
                else K.All()
            csel = node.args["csel"] if node.args["csel"] is not None \
                else K.All()
            return a[rsel, csel]
        if op == "transpose":
            return self.run(node.children[0]).transpose()
        if op in _FUSABLE:
            return self._exec_fused(node, sp)
        if op == "add":
            return self.run(node.children[0]) + self.run(node.children[1])
        if op == "sub":
            return self.run(node.children[0]) - self.run(node.children[1])
        if op == "emul":
            return self.run(node.children[0]).multiply(
                self.run(node.children[1]))
        if op == "matmul":
            return self._exec_matmul(node, sp)
        return self._exec_sum(node, sp)

    # -- elementwise fusion ------------------------------------------------
    def _exec_fused(self, node: LazyAssoc, sp) -> Assoc:
        """Collapse a unary elementwise chain into one pass over the csr
        payload: no per-stage Assoc rebuild, one compaction at the end."""
        chain = []
        cur = node
        while cur.op in _FUSABLE:
            chain.append(cur)
            cur = cur.children[0]
        base = self.run(cur)
        ops = chain[::-1]  # innermost first
        if sp.live:
            sp.tag(ops=[o.op for o in ops])

        if base.val is not None and any(o.op == "filter" for o in ops):
            # categorical comparisons keep eager (string dictionary)
            # semantics; fusion only covers the numeric payload.
            return _apply_eager(base, ops)

        sm = base._numeric_sm().copy()
        data = sm.data.astype(np.float64, copy=True)
        alive = np.ones(data.shape[0], dtype=bool)
        filtered = False
        for o in ops:
            if o.op == "logical":
                data = np.ones_like(data)
            elif o.op == "scale":
                data = data * o.args["k"]
            elif o.op == "shift":
                data = data + o.args["k"]
            else:  # filter — eager rebuilds here, which also drops
                # entries that are exactly zero *at this stage* (the
                # Assoc constructor eliminates zeros); later scalar ops
                # may reintroduce explicit zeros, which eager keeps.
                alive &= _CMPS[o.args["cmp"]](data, o.args["x"])
                alive &= data != 0.0
                filtered = True
        if not filtered:
            sm.data = data
            return Assoc._from_parts(base.row, base.col, None, sm)
        # Drop dead entries and compact keys by *pattern*, preserving any
        # explicit zeros among the survivors (eager parity).
        import scipy.sparse as sp
        coo = sm.tocoo()  # canonical csr ⇒ data aligned with sm.data
        rk, ck, dk = coo.row[alive], coo.col[alive], data[alive]
        rmask = np.zeros(sm.shape[0], dtype=bool)
        rmask[rk] = True
        cmask = np.zeros(sm.shape[1], dtype=bool)
        cmask[ck] = True
        rmap = np.cumsum(rmask) - 1
        cmap = np.cumsum(cmask) - 1
        out = sp.csr_matrix((dk, (rmap[rk], cmap[ck])),
                            shape=(int(rmask.sum()), int(cmask.sum())))
        return Assoc._from_parts(base.row[rmask], base.col[cmask], None, out)

    # -- matmul with optional device lowering ------------------------------
    def _exec_matmul(self, node: LazyAssoc, sp) -> Assoc:
        # Fused chain lowering: a left-spine matmul chain ending in a
        # vector (A @ B @ x) runs as successive device products with the
        # intermediate vector staying on device — no host round-trips
        # between factors.  Reassociation (A@B)@x → A@(B@x) is licensed
        # by plus_times semiring algebra (float32 accumulation, same
        # precision contract as all device lowering).
        parts = _chain_parts(node)      # [A, B, ..., x]
        if len(parts) >= 3:
            mats = [self.run(f) for f in parts]
            outs = _lower_chain(mats[:-1], mats[-1:])
            if outs is not None:
                sp.tag(route="chain")
                return outs[0]
        a = self.run(node.children[0])
        b = self.run(node.children[1])
        with _span("planner.exec.align") as al:
            asm, bsm, inner = a._inner_aligned(b)
            al.tag(path=inner.path)
        vector_out = b.col.shape[0] == 1 and asm.nnz >= DEVICE_NNZ_THRESHOLD
        sp.tag(route="spmv" if vector_out else "host")
        if vector_out:
            x = S.to_device(np.asarray(bsm.todense()).ravel(), torch.float32)
            y = _device_product(asm, x).cpu().numpy().astype(np.float64)
            return _column(a.row, b.col, y)
        return Assoc._from_parts(a.row, b.col, None, asm @ bsm)._compact()

    # -- sum with device lowering ------------------------------------------
    def _exec_sum(self, node: LazyAssoc, sp) -> Assoc:
        a = self.run(node.children[0])
        axis = node.args["axis"]
        if a.nnz < DEVICE_NNZ_THRESHOLD or a.nnz == 0:
            sp.tag(route="host")
            return a.sum(axis)
        sp.tag(route="device")
        coo = a.device_coo()
        if axis in (1, 2):
            v = S.row_degree(coo, weighted=True).cpu().numpy().astype(
                np.float64)
            keep = v != 0
            n = int(keep.sum())
            return Assoc._from_parts(
                a.row[keep], np.asarray([""]), None,
                S.scipy_from_triples(np.arange(n), np.zeros(n, np.int64),
                                     v[keep], (n, 1)))
        v = S.col_degree(coo, weighted=True).cpu().numpy().astype(np.float64)
        keep = v != 0
        n = int(keep.sum())
        return Assoc._from_parts(
            np.asarray([""]), a.col[keep], None,
            S.scipy_from_triples(np.zeros(n, np.int64), np.arange(n),
                                 v[keep], (1, n)))


def _apply_eager(base: Assoc, ops) -> Assoc:
    out = base
    for o in ops:
        if o.op == "logical":
            out = out.logical()
        elif o.op == "scale":
            out = out * o.args["k"]
        elif o.op == "shift":
            out = out + o.args["k"]
        else:
            out = getattr(out, f"__{o.args['cmp']}__")(o.args["x"])
    return out


def _ell_pack(asm):
    """CSR payload → device ELL pack with ``k_max = max(nnz per row)``."""
    csr = asm.tocsr()
    k_max = int(max(np.diff(csr.indptr).max(), 1))
    ecols, evals = kspmv.csr_to_ell(csr.indptr, csr.indices, csr.data,
                                    csr.shape[0], k_max)
    dev = get_device()
    return torch.from_numpy(ecols).to(dev), torch.from_numpy(evals).to(dev)


def _device_product(fsm, Y: torch.Tensor) -> torch.Tensor:
    """``fsm @ Y`` on device through the ELL kernels: a 1-D ``Y`` by
    ``spmv_ell``, an (n, b) block by ``spmm_ell``, the batched unit that
    answers all b queries in one launch."""
    one = Y.dim() == 1
    name = "spmv" if one else "spmm"
    tags = {} if one else {"b": int(Y.shape[1])}
    with _span(f"kernel.{name}", nnz=fsm.nnz, **tags):
        _KERNEL_COUNTERS[name].inc()
        kernel = kspmv.spmv_ell if one else kspmm.spmm_ell
        return kernel(*_ell_pack(fsm), Y.to(torch.float32).contiguous())


def _column(rkeys: np.ndarray, ckey: np.ndarray, v: np.ndarray) -> Assoc:
    """The one-column Assoc of host vector ``v`` over ``rkeys`` and the
    column key ``ckey``, its zeros and empty rows dropped."""
    n = v.shape[0]
    sm = S.scipy_from_triples(np.arange(n), np.zeros(n, np.int64), v, (n, 1))
    sm.eliminate_zeros()
    return Assoc._from_parts(rkeys, ckey, None, sm)._compact()


def _align_factor(F: Assoc, y_keys: np.ndarray):
    """A chain factor's payload over ``F.col`` ∩ ``y_keys`` (None when
    they share no key), and that alignment."""
    inner = K.align(F.col, y_keys, "inter")
    k = inner.keys.shape[0]
    fsm = F._onto(None, inner.ia, (F.row.shape[0], k)) if k else None
    return fsm, inner


def _take_rows(y: torch.Tensor, ix) -> torch.Tensor:
    """The rows of ``y`` (indexed by a dictionary) at the keys an
    intersection map ``ix`` keeps; ``y`` itself for the identity."""
    if ix is None:
        return y
    keep = torch.from_numpy(np.flatnonzero(ix >= 0))
    return y.index_select(0, keep.to(y.device))


def _lower_chain(factors, vecs) -> Optional[list]:
    """Lower the chains A @ B @ ... @ x_j (one factor list, one or more
    vectors) to one device product per factor, the intermediate staying
    on device.  One vector stays a 1-D ``y`` (SpMV); two or more stack
    into the zero-padded block X = [x_1 … x_b] (SpMM), so every factor
    streams from memory once for the whole batch, and column j
    reproduces chain j exactly under plus_times (padding zeros
    contribute nothing).  Returns the result columns, or None when the
    chain does not lower (a vector that is not one nonempty column, an
    empty factor, or every factor below DEVICE_NNZ_THRESHOLD) so the
    callers fall back to host matmuls."""
    if any(v.col.shape[0] != 1 or v.nnz == 0 for v in vecs):
        return None
    if any(f.nnz == 0 for f in factors):
        return None
    if max(f.nnz for f in factors) < DEVICE_NNZ_THRESHOLD:
        return None
    y_keys = vecs[0].row
    for v in vecs[1:]:
        y_keys = K.align(y_keys, v.row, "union").keys
    X = np.zeros((y_keys.shape[0], len(vecs)), np.float32)
    for j, v in enumerate(vecs):
        # v.row ⊆ y_keys, both sorted; a lone vector's rows are y_keys
        idx = slice(None) if v.row is y_keys else \
            np.searchsorted(y_keys, v.row)
        X[idx, j] = np.asarray(v._numeric_sm().todense()).ravel()
    Y = S.to_device(X[:, 0] if len(vecs) == 1 else X, torch.float32)
    for F in reversed(factors):
        with _span("planner.exec.align") as al:
            fsm, inner = _align_factor(F, y_keys)
            al.tag(path=inner.path)
        y_keys = F.row
        Y = (Y.new_zeros((F.row.shape[0],) + Y.shape[1:]) if fsm is None
             else _device_product(fsm, _take_rows(Y, inner.ib)))
    Yh = Y.cpu().numpy().astype(np.float64)     # single host transfer
    Yh = Yh.reshape(Yh.shape[0], -1)
    return [_column(y_keys, v.col, Yh[:, j]) for j, v in enumerate(vecs)]


# The batch route calls the chain by this name: the benchmark's fault
# test (bench/tests/test_bench_cells.py, ``_half_batch``) patches it.
_device_matmul_chain_multi = _lower_chain


# ---------------------------------------------------------------------------
# Batch evaluation: N expressions, one executor, fused device launches.
# ---------------------------------------------------------------------------

def lazy_batch(exprs) -> list:
    """Wrap a sequence of expressions (Assoc / LazyAssoc / table) into
    deferred nodes destined for one :func:`eval_batch` call."""
    return [LazyAssoc.wrap(x) for x in exprs]


def eval_batch(exprs) -> list:
    """Evaluate N independent expressions as ONE batch.

    Beyond per-DAG planning, the batch executor exploits *cross*-expression
    structure (arXiv:2309.02464's real-time trick — many hypersparse
    queries per launch):

    * **batch CSE** — one shared executor memoizes across all N DAGs, so
      structurally identical subtrees (the same table scan issued by
      every member) execute once;
    * **scan batching** — distinct scans against the same
      :class:`~repro_torch.db.binding.DBTable` prefetch through
      ``table._scan_batch``: one union tablet scan per physical route,
      split per member host-side (each member still lands its own
      :class:`~repro_torch.db.binding.ScanCache` entry);
    * **SpMM chain fusion** — matvec chains over identical factor lists
      (same structural scan key, different tail vectors) stack their
      vectors into a dense multi-vector and run as one device SpMM
      launch per factor (:func:`_lower_chain`) instead of N SpMV
      launches, the intermediate multi-vector staying on device.

    Returns the evaluated :class:`Assoc` list, aligned with the input.
    Error semantics match per-member ``.eval()``: a member whose scan
    raises (e.g. the degree guard) raises when *that* member executes —
    such members are simply excluded from the fused prefetch.
    """
    nodes = [LazyAssoc.wrap(x) for x in exprs]
    with _span("planner.eval_batch", n=len(nodes)):
        ex = _Executor()
        plans = [n if n._value is not None else _optimize(n) for n in nodes]
        live = [p for n, p in zip(nodes, plans) if n._value is None]
        if len(live) >= 2:
            _prefetch_batch_scans(live, ex)
            _fuse_chain_groups(live, ex)
        out = []
        for n, p in zip(nodes, plans):
            if n._value is None:
                n._value = ex.run(p)
            out.append(n._value)
    return out


def _collect_scans(node: LazyAssoc, out: dict) -> None:
    if node._value is not None:
        return
    if node.op == "scan":
        out.setdefault(_skey(node), node)
    for c in node.children:
        _collect_scans(c, out)


def _prefetch_batch_scans(plans, ex: "_Executor") -> None:
    """Group the batch's distinct scan leaves by table and serve each
    group through one ``_scan_batch`` union scan, seeding the executor's
    memo (members the table declines stay lazy and scan individually)."""
    scans: dict = {}
    for p in plans:
        _collect_scans(p, scans)
    by_table: dict = {}
    for key, node in scans.items():
        if key in ex._memo:
            continue
        t = node.args["table"]
        if hasattr(t, "_scan_batch"):
            by_table.setdefault(id(t), []).append((key, node))
    for group in by_table.values():
        if len(group) < 2:
            continue            # nothing to amortize
        table = group[0][1].args["table"]
        sels = [(n.args["rsel"], n.args["csel"]) for _, n in group]
        results = table._scan_batch(sels)
        for (key, _), a in zip(group, results):
            if a is not None:
                ex._memo[key] = a


def _chain_parts(node: LazyAssoc) -> list:
    """[A, B, ..., x] for a left-spine matmul chain root; [node] when it
    is no product."""
    parts = []
    while node.op == "matmul":
        parts.append(node.children[1])
        node = node.children[0]
    parts.append(node)
    return parts[::-1]


def _fuse_chain_groups(plans, ex: "_Executor") -> None:
    """Find matvec chains sharing an identical factor list and execute
    each group as one SpMM launch, seeding the executor's memo with the
    per-chain result columns."""
    groups: dict = {}
    for p in plans:
        parts = _chain_parts(p)
        if len(parts) < 2:
            continue
        fkey = tuple(_skey(f) for f in parts[:-1])
        # dedupe by root skey — exact duplicates are already CSE'd
        groups.setdefault(fkey, {}).setdefault(_skey(p), parts)
    for chains in groups.values():
        if len(chains) < 2:
            continue
        # factor/tail evaluation goes through the shared executor, so
        # scans hit the batch-prefetched memo entries
        any_parts = next(iter(chains.values()))
        factors = [ex.run(f) for f in any_parts[:-1]]
        tails = [(rkey, ex.run(parts[-1]))
                 for rkey, parts in chains.items()]
        elig = [(rkey, v) for rkey, v in tails
                if v.col.shape[0] == 1 and v.nnz > 0]
        if len(elig) < 2:
            continue
        outs = _device_matmul_chain_multi(factors, [v for _, v in elig])
        if outs is None:
            continue
        for (rkey, _), out in zip(elig, outs):
            ex._memo[rkey] = out
