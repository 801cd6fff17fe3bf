"""Graph construction and device-side graph algebra.

The incidence matrix ``E`` (packets × field|value columns) produced by
the D4M schema directly encodes the network graph: selecting the
``ip.src|*`` block and the ``ip.dst|*`` block and correlating them
(``E_src' * E_dst``) yields the directed source→destination adjacency
matrix (paper §IV-E/F, and Fig. 2's "find 1.1.1.1's connections").

Host-side functions operate on :class:`Assoc` (exact, string-keyed);
device-side functions operate on :class:`repro_torch.core.sparse.COO`
tensors, with each of the reference's ``lax.scan`` loops written as a
Python loop.
"""
from __future__ import annotations

import numpy as np
import torch

from . import keys as K
from . import sparse as S
from .assoc import Assoc, StartsWith


# ---------------------------------------------------------------------------
# Host-side (Assoc) graph construction — mirrors the paper's D4M listings.
# ---------------------------------------------------------------------------

def adjacency(E: Assoc, src_field: str = "ip.src", dst_field: str = "ip.dst",
              sep: str = "|") -> Assoc:
    """Directed adjacency  A[src, dst] = #packets  from the incidence matrix."""
    # columns are field|value ⇒ select column blocks:
    Esrc = E[:, StartsWith(f"{src_field}{sep}")]
    Edst = E[:, StartsWith(f"{dst_field}{sep}")]
    A = Esrc.T * Edst  # (src values) × (dst values), packet-count weighted
    # strip the 'field|' prefixes so keys are bare IPs
    r, c, v = A.triples()
    strip = len(src_field) + len(sep)
    stripd = len(dst_field) + len(sep)
    return Assoc(np.asarray([k[strip:] for k in r], dtype=str),
                 np.asarray([k[stripd:] for k in c], dtype=str), v)


def square(A: Assoc) -> Assoc:
    """Promote to a square array over the union of row/col keys (needed
    before spectral/PageRank work on a directed adjacency)."""
    nodes = K.align(A.row, A.col, "union")
    n = nodes.keys.shape[0]
    sm = A._onto(nodes.ia, nodes.ib, (n, n))
    return Assoc._from_parts(nodes.keys, nodes.keys, None, sm)


def connections(E: Assoc, ip: str, src_field: str = "ip.src",
                dst_field: str = "ip.dst", sep: str = "|") -> Assoc:
    """Fig. 2's operation: every host that ``ip`` talked to (either
    direction), as a packet-count-valued associative array."""
    out_pkts = E[:, [f"{src_field}{sep}{ip}"]]
    in_pkts = E[:, [f"{dst_field}{sep}{ip}"]]
    # packets involving ip → all their other endpoint columns
    touched = (out_pkts.sum(1) + in_pkts.sum(1)).logical()  # packets × ['']
    sel = touched.T * E  # 1 × columns, counts per field|value
    return sel[:, StartsWith(f"{dst_field}{sep}")] + \
        sel[:, StartsWith(f"{src_field}{sep}")]


def degree_table(E: Assoc) -> Assoc:
    """``TedgeDeg``: per-column-key degree (stage 6's
    ``Edeg = putCol(sum(E.',2),'degree,')``)."""
    return E.T.sum(1).putcol("degree,")


# ---------------------------------------------------------------------------
# Device-side (COO) graph algebra — semiring-generic, on the COO's device.
# ---------------------------------------------------------------------------

def pagerank(adj: S.COO, num_iters: int = 20,
             damping: float = 0.85) -> torch.Tensor:
    """PageRank on a directed adjacency COO (Bottrack-style botnet
    centrality, paper ref [23]).  Dangling mass redistributed uniformly."""
    n = adj.shape[0]
    out_deg = S.row_degree(adj, weighted=True)
    inv_deg = torch.where(out_deg > 0, 1.0 / torch.clamp(out_deg, min=1e-30),
                          0.0)
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=adj.device)
    for _ in range(num_iters):
        contrib = rank * inv_deg
        spread = S.spmv_t(adj, contrib)  # mass flows src→dst
        dangling = torch.where(out_deg > 0, 0.0, rank).sum()
        rank = (1 - damping) / n + damping * (spread + dangling / n)
    return rank


def triangle_count(adj: S.COO, probe: torch.Tensor) -> torch.Tensor:
    """Randomized triangle-mass estimate  ≈ tr(A³)/6 via Hutchinson probes
    (z' A³ z).  ``probe``: (n, k) ±1.  Used as a density anomaly score."""
    az = S.spmm(adj, probe)
    aaz = S.spmm(adj, az)
    aaaz = S.spmm(adj, aaz)
    return torch.mean(torch.sum(probe * aaaz, dim=0)) / 6.0


def degree_counts(m: S.COO) -> tuple[torch.Tensor, torch.Tensor]:
    """(row_degrees, col_degrees) of an incidence/adjacency payload."""
    return S.row_degree(m), S.col_degree(m)


def bfs_reachable(adj: S.COO, seed: torch.Tensor,
                  hops: int = 3) -> torch.Tensor:
    """Boolean k-hop reachability via the or_and semiring (command-and-
    control spread estimation)."""
    frontier = seed.to(torch.float32)
    for _ in range(hops):
        nxt = S.spmv_t(adj, frontier, ring="or_and")
        frontier = torch.maximum(frontier, nxt)
    return frontier > 0
