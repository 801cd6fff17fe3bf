"""Big-data dimensional analysis (paper ref [25]).

Field-level structural statistics over the exploded schema: per-field
cardinality, entropy, and cross-field correlation strength.  These are
the "know your data before you model it" diagnostics the paper's group
runs first on any new capture.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.assoc import Assoc, StartsWith


def field_names(E: Assoc, sep: str = "|") -> List[str]:
    return sorted({c.split(sep, 1)[0] for c in E.col})


def field_stats(E: Assoc, sep: str = "|") -> Dict[str, dict]:
    """Cardinality + Shannon entropy per field of an incidence matrix."""
    out: Dict[str, dict] = {}
    for f in field_names(E, sep):
        block = E[:, StartsWith(f + sep)]
        counts = np.asarray(block.sum(0).triples()[2], np.float64)
        p = counts / counts.sum()
        out[f] = {
            "cardinality": int(block.shape[1]),
            "entropy_bits": float(-(p * np.log2(p)).sum()),
            "total": float(counts.sum()),
        }
    return out


def field_correlation(E: Assoc, f1: str, f2: str, sep: str = "|") -> Assoc:
    """Cross-field correlation array  E_f1' * E_f2 — e.g. which source
    talks on which port.  This is the workhorse join of the D4M style."""
    A = E[:, StartsWith(f1 + sep)]
    B = E[:, StartsWith(f2 + sep)]
    return A.T * B


def top_correlated_pairs(E: Assoc, sep: str = "|",
                         top_k: int = 5) -> List[Tuple[str, str, float]]:
    """Rank field pairs by normalized co-occurrence mass — a quick map of
    which header dimensions carry joint structure."""
    fields = field_names(E, sep)
    out = []
    for i, f1 in enumerate(fields):
        for f2 in fields[i + 1:]:
            C = field_correlation(E, f1, f2, sep)
            if C.nnz == 0:
                continue
            v = np.asarray(C.triples()[2], np.float64)
            # concentration: fraction of mass on the top cell
            out.append((f1, f2, float(v.max() / v.sum())))
    out.sort(key=lambda t: -t[2])
    return out[:top_k]
