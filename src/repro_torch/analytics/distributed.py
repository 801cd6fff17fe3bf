"""Sharded sparse analytics: degree tables, SpMV and PageRank as
nnz-sharded segment reductions combined by a sum over shards.

The reference shards the incidence/adjacency payload across a device
mesh and combines with ``psum``.  Here the world is one device, so each
helper reduces the whole payload and the combine is the identity.  The
shard padding convention holds throughout: dead entries at
``row == nrows`` (:func:`shard_coo`, ``sparse.coalesce``) contribute
nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import semiring as sr
from ..core.sparse import COO
from ..device import get_device


def shard_coo(m: COO, n_shards: int) -> COO:
    """Split nnz into equal row-contiguous shards (pad with dead entries
    at row == nrows). Returns a COO whose leading dim stacks shards."""
    nnz = m.nnz
    per = -(-nnz // n_shards)
    pad = per * n_shards - nnz

    def padded(t, fill):
        return torch.cat([t, torch.full((pad,), fill, dtype=t.dtype,
                                        device=t.device)])

    return COO(padded(m.rows, m.shape[0]).reshape(n_shards, per),
               padded(m.cols, 0).reshape(n_shards, per),
               padded(m.vals, 0).reshape(n_shards, per), m.shape)


def degree_sharded(m: COO) -> torch.Tensor:
    """Column degrees of a COO (live entries only)."""
    live = (m.rows < m.shape[0]).to(m.vals.dtype)
    return sr.segment_reduce(live, m.cols, m.shape[1], "sum")


def spmv_t_sharded(m: COO, x: torch.Tensor) -> torch.Tensor:
    """y[j] = Σ_i m[i,j]·x[i] over live entries (PageRank inner op)."""
    n_rows, n_cols = m.shape
    safe = torch.clamp(m.rows.long(), max=n_rows - 1)
    live = (m.rows < n_rows).to(m.vals.dtype)
    return sr.segment_reduce(m.vals * live * x[safe], m.cols, n_cols, "sum")


def spmv_weighted_rowsum(m: COO) -> torch.Tensor:
    """Row sums (weighted out-degree) over live entries."""
    n_rows = m.shape[0]
    live = (m.rows < n_rows).to(m.vals.dtype)
    return sr.segment_reduce(m.vals * live, m.rows, n_rows, "sum")


def pagerank_sharded(adj: COO, num_iters: int = 20, damping: float = 0.85,
                     personalize: torch.Tensor | None = None) -> torch.Tensor:
    """PageRank with the sharded SpMV inner loop.

    ``personalize`` (n,) replaces the uniform restart distribution: the
    random surfer teleports to those nodes instead of anywhere, and
    dangling mass is redistributed the same way — personalized PageRank
    (the MicroRCA root-cause localization primitive)."""
    n = adj.shape[0]
    if personalize is None:
        p = torch.full((n,), 1.0 / n, dtype=torch.float32, device=adj.device)
    else:
        p = torch.clamp(personalize.to(torch.float32), min=0.0)
        p = p / torch.clamp(torch.sum(p), min=1e-30)
    out_deg_w = spmv_weighted_rowsum(adj)
    inv_deg = torch.where(out_deg_w > 0,
                          1.0 / torch.clamp(out_deg_w, min=1e-30), 0.0)
    rank = p
    for _ in range(num_iters):
        contrib = rank * inv_deg
        spread = spmv_t_sharded(adj, contrib)
        dangling = torch.sum(torch.where(out_deg_w > 0, 0.0, rank))
        rank = (1 - damping) * p + damping * (spread + dangling * p)
    return rank


def pagerank_table(T, num_iters: int = 20,
                   src_field: str = "ip.src", dst_field: str = "ip.dst",
                   sep: str = "|", personalize: dict | None = None,
                   reverse: bool = False, damping: float = 0.85
                   ) -> tuple[np.ndarray, torch.Tensor]:
    """PageRank served straight from the database binding.

    Queries the src/dst column blocks through the :class:`DBTable`
    selection grammar (pushed-down transpose-table scans), builds the
    host adjacency, then runs the sharded PageRank on the device
    payload.  Returns ``(node_keys, ranks)`` aligned by index.

    ``T`` may equally be an in-memory incidence :class:`Assoc` (a
    streaming window slice) — anything speaking the selection grammar.
    ``personalize`` maps host keys to restart weights (personalized
    PageRank); ``reverse`` transposes the adjacency first, so mass flows
    from a seed *victim* back to the hosts feeding it traffic — the
    MicroRCA root-cause direction.
    """
    from ..core import graph

    E = T[:, f"{src_field}{sep}*,"] + T[:, f"{dst_field}{sep}*,"]
    adj = graph.square(graph.adjacency(
        E, src_field=src_field, dst_field=dst_field, sep=sep))
    if adj.nnz == 0:
        return np.empty((0,), dtype=str), torch.zeros(
            0, dtype=torch.float32, device=get_device())
    if reverse:
        adj = adj.T
    coo = adj.device_coo(torch.float32)
    p = None
    if personalize is not None:
        w = np.zeros(adj.row.shape[0], np.float32)
        pos = np.searchsorted(adj.row, list(personalize))
        for k, i in zip(personalize, pos):
            if i < adj.row.shape[0] and adj.row[i] == k:
                w[i] = float(personalize[k])
        if w.sum() > 0:             # else no seed present — uniform restart
            p = torch.from_numpy(w).to(coo.device)
    ranks = pagerank_sharded(coo, num_iters=num_iters,
                             personalize=p, damping=damping)
    return adj.row, ranks
