"""The least bytes an ELL product needs, and its least time on the card.

The formula follows ``ell_bound`` in ``chip_smoke.py`` at commit
a897cbcf57db933d5cd5b4978c4bd7d258c18c54, changed in one respect as the
roofline rule asks: the factor is counted by its stored entries (a column
index and a value, 4 bytes each, read once), not by its padded pack.  The
multi-vector's rows that the factor touches are read once and the result
is written once, 4 bytes an element.  The benchmark counts these from its
own reference's factor for the same request, never from the program's
pack.  Later PRs of the program do not edit this file.
"""
from __future__ import annotations

from .peaks import FP32_FLOPS, HBM_BYTES_PER_S


def ell_bytes(nnz: int, n_inner: int, n_rows: int, b: int) -> int:
    """Bytes of one ``Y = F @ X`` with ``F`` (n_rows x n_inner) holding
    ``nnz`` stored entries and ``X`` (n_inner x b) dense float32."""
    return 8 * nnz + 4 * n_inner * b + 4 * n_rows * b


def ell_seconds(nnz: int, n_inner: int, n_rows: int, b: int) -> float:
    """Least time of that product on the card: the larger of its bytes
    at the HBM rate and its 2 * nnz * b operations at the float32 rate."""
    return max(ell_bytes(nnz, n_inner, n_rows, b) / HBM_BYTES_PER_S,
               2.0 * nnz * b / FP32_FLOPS)
