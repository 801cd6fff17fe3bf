"""repro_torch.core — D4M associative arrays, semiring sparse algebra, schema.

The paper's primary contribution as a composable PyTorch library:

* :class:`Assoc` — string-keyed associative arrays (paper §II-B).
* :mod:`repro_torch.core.sparse` — device COO/CSR payloads + semiring SpMV/SpMM.
* :mod:`repro_torch.core.schema` — the D4M exploded schema (val2col/col2val).
* :mod:`repro_torch.core.graph` — incidence→adjacency, degree tables, PageRank.
"""
from .assoc import All, Assoc, KeyRange, StartsWith
from .expr import LazyAssoc, eval_batch, lazy, lazy_batch
from .schema import col2val, parse_tsv, to_tsv, val2col
from .semiring import (MAX_MIN, MAX_PLUS, MAX_TIMES, MIN_PLUS, OR_AND,
                       PLUS_TIMES, Semiring)
from .sparse import COO, CSR, coo_to_csr, csr_to_coo, col_degree, row_degree, \
    spmm, spmv, spmv_t
from . import graph

__all__ = [
    "Assoc", "All", "KeyRange", "StartsWith", "LazyAssoc", "lazy",
    "lazy_batch", "eval_batch",
    "parse_tsv", "to_tsv", "val2col", "col2val",
    "Semiring", "PLUS_TIMES", "MIN_PLUS", "MAX_PLUS", "MAX_MIN", "MAX_TIMES",
    "OR_AND",
    "COO", "CSR", "coo_to_csr", "csr_to_coo", "spmv", "spmv_t", "spmm",
    "row_degree", "col_degree", "graph",
]
