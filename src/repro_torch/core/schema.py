"""The D4M schema — exploding dense tables into sparse incidence matrices.

This is the paper's stage 4→5 transformation.  A parsed TSV of packet
headers is first a *dense* associative array (rows = packet IDs, columns
= header fields, values = field strings).  ``val2col`` explodes it into
the *sparse* representation: column keys become ``field|value`` and every
stored value becomes 1 — the **incidence matrix** of the network graph
(paper §III-B steps 4–5, listing in §IV-E).

``col2val`` is the inverse, recovering the dense table from the graph.
"""
from __future__ import annotations

import numpy as np

from .assoc import Assoc


def parse_tsv(text: str, row_prefix: str = "") -> Assoc:
    """Parse a TSV (header line = field names, first col = row id) into a
    dense associative array.  Mirrors D4M's ``ReadCSV``/parse step."""
    lines = [ln for ln in text.split("\n") if ln.strip()]
    if not lines:
        return Assoc()
    header = lines[0].split("\t")
    fields = header[1:]
    rows, cols, vals = [], [], []
    for ln in lines[1:]:
        parts = ln.split("\t")
        rid = row_prefix + parts[0]
        for f, v in zip(fields, parts[1:]):
            if v != "":
                rows.append(rid)
                cols.append(f)
                vals.append(v)
    return Assoc(np.asarray(rows, dtype=str), np.asarray(cols, dtype=str),
                 np.asarray(vals, dtype=str))


def to_tsv(dense: Assoc) -> str:
    """Inverse of :func:`parse_tsv` (round-trip used in tests)."""
    r, c, v = dense.triples()
    fields = list(dense.col)
    fi = {f: i for i, f in enumerate(fields)}
    by_row: dict[str, list[str]] = {}
    for rr, cc, vv in zip(r, c, v):
        by_row.setdefault(rr, [""] * len(fields))[fi[cc]] = str(vv)
    out = ["\t".join(["id"] + fields)]
    for rid in dense.row:
        out.append("\t".join([rid] + by_row.get(rid, [""] * len(fields))))
    return "\n".join(out) + "\n"


def val2col(dense: Assoc, sep: str = "|") -> Assoc:
    """Dense table → sparse incidence matrix (``E = val2col(A,'|')``)."""
    r, c, v = dense.triples()
    if r.shape[0] == 0:
        return Assoc()
    vstr = np.asarray(v, dtype=str) if dense.val is not None else \
        np.asarray([f"{x:g}" for x in np.asarray(v, np.float64)], dtype=str)
    newcols = np.char.add(np.char.add(c.astype(str), sep), vstr)
    return Assoc(r, newcols, np.ones(r.shape[0]))


def col2val(sparse_e: Assoc, sep: str = "|") -> Assoc:
    """Sparse incidence matrix → dense table (inverse of val2col)."""
    r, c, _ = sparse_e.triples()
    if r.shape[0] == 0:
        return Assoc()
    split = np.char.partition(c.astype(str), sep)
    fields, vals = split[:, 0], split[:, 2]
    return Assoc(r, fields, vals.astype(str))
