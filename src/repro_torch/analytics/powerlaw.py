"""Power-law background modeling for network graphs (paper refs [25],[26]).

Internet host-popularity follows a heavy-tailed (power-law / Zipf)
distribution; the Gadepally–Kepner approach models this background so
that *deviations* from it — hosts far off the rank-size line — surface as
anomalies (C2 servers, scanners), instead of simply "the biggest talkers".

Everything numeric here is torch on the degree vector's device (float32),
over degree vectors produced from the incidence matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import semiring as sr
from ..core.sparse import to_device
from ..obs.trace import span as _span
from .serialize import JsonReportMixin


class PowerLawFit(NamedTuple):
    alpha: torch.Tensor      # rank-size exponent (degree ~ C · rank^-alpha)
    log_c: torch.Tensor      # intercept
    resid: torch.Tensor      # per-rank log residual (obs - model)
    r2: torch.Tensor

    # JSON report path (tensor scalars coerced; see analytics.serialize)
    to_dict = JsonReportMixin.to_dict
    to_json = JsonReportMixin.to_json
    from_dict = classmethod(JsonReportMixin.from_dict.__func__)


def fit_rank_size(degrees: torch.Tensor) -> PowerLawFit:
    """Weighted least-squares fit of log(degree) vs log(rank).

    ``degrees``: (n,) nonneg; zeros are ignored via weighting.  Head ranks
    get full weight, the noisy tail is down-weighted logarithmically —
    the standard correction for rank-size regression bias.
    """
    d = torch.sort(degrees.to(torch.float32), descending=True).values
    n = d.shape[0]
    rank = torch.arange(1, n + 1, dtype=torch.float32, device=d.device)
    w = torch.where(d > 0, 1.0 / torch.log1p(rank), 0.0)
    x = torch.log(rank)
    y = torch.log(torch.clamp(d, min=1e-9))
    wsum = torch.sum(w)
    xm = torch.sum(w * x) / wsum
    ym = torch.sum(w * y) / wsum
    cov = torch.sum(w * (x - xm) * (y - ym))
    var = torch.sum(w * (x - xm) ** 2)
    slope = cov / torch.clamp(var, min=1e-9)
    intercept = ym - slope * xm
    model = intercept + slope * x
    resid = torch.where(d > 0, y - model, 0.0)
    ss_res = torch.sum(w * resid ** 2)
    ss_tot = torch.sum(w * (y - ym) ** 2)
    return PowerLawFit(-slope, intercept, resid,
                       1.0 - ss_res / torch.clamp(ss_tot, min=1e-9))


def degree_histogram(degrees: torch.Tensor, n_bins: int = 64):
    """Log-binned degree histogram n(d) — the degree-distribution view."""
    d = torch.clamp(degrees.to(torch.float32), min=0.0)
    logd = torch.log1p(d)
    hi = max(float(torch.max(logd)), 1e-6)
    edges = torch.linspace(0.0, hi * (1 + 1e-6), n_bins + 1,
                           device=d.device)
    idx = torch.clamp(torch.searchsorted(edges, logd, right=True) - 1,
                      0, n_bins - 1)
    counts = sr.segment_reduce(torch.ones_like(logd), idx, n_bins, "sum")
    centers = torch.expm1(0.5 * (edges[:-1] + edges[1:]))
    return centers, counts


def fit_degree_table(T, prefix: str = "ip.dst|") -> PowerLawFit:
    """Fit the rank-size background straight from the database's
    combiner-maintained degree table (TedgeDeg) through a
    :class:`~repro_torch.db.binding.DBTable` binding — no incidence-matrix
    materialization, which is how the paper sizes the background model
    at ingest rates."""
    with _span("analytics.fit_degree_table"):
        deg = T.degree_assoc(prefix)
        if deg.nnz == 0:
            return fit_rank_size(to_device(np.zeros(1, np.float32)))
        return fit_rank_size(to_device(np.asarray(deg.triples()[2],
                                                  np.float32)))


def background_scores(degrees: torch.Tensor) -> torch.Tensor:
    """Anomaly score per vertex: positive log-residual above the fitted
    rank-size background, mapped back from rank order to vertex order."""
    order = torch.argsort(degrees, stable=True).flip(0)
    fit = fit_rank_size(degrees)
    scores_ranked = torch.clamp(fit.resid, min=0.0)
    inv = torch.zeros_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return scores_ranked[inv]
