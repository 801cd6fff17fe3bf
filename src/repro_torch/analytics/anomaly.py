"""Botnet / C2 detection on the ingested incidence matrix.

Three detectors, all expressed in associative-array algebra (host side)
with torch scoring on the device — the paper's §III-A analytic menu:

* **fan-in outliers** — unique-source in-degree far above the power-law
  background (C2 servers aggregate many bots).
* **beacon regularity** — per-destination contact pattern across time
  buckets with anomalously low coefficient-of-variation (periodic,
  machine-driven traffic: the injected beacons).
* **port concentration** — destinations whose traffic is concentrated on
  one unusual port (C2 channels ride fixed ports).

``detect_c2`` fuses the three scores; validated against
``pipeline.botnet_truth`` in the test suite.

Detectors accept any object speaking the Assoc selection grammar: an
in-memory :class:`Assoc`, a deferred :class:`~repro_torch.core.expr.LazyAssoc`,
or a live :class:`~repro_torch.db.binding.DBTable` — in the last case each
``E[:, StartsWith(...)]`` block below becomes a pushed-down transpose-
table scan that reads only that column band from the database.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from ..core.assoc import Assoc, StartsWith
from ..core.expr import LazyAssoc
from ..core.sparse import to_device
from ..obs.trace import span as _span
from . import powerlaw
from .serialize import JsonReportMixin

Queryable = Union[Assoc, LazyAssoc, "DBTable"]  # anything with E[r, c]


class C2Report(NamedTuple):
    hosts: np.ndarray          # candidate dst IPs, best first
    scores: np.ndarray
    fanin: np.ndarray
    regularity: np.ndarray
    port_conc: np.ndarray

    # JSON report path (numpy/torch fields coerced; see analytics.serialize)
    to_dict = JsonReportMixin.to_dict
    to_json = JsonReportMixin.to_json
    from_dict = classmethod(JsonReportMixin.from_dict.__func__)


class C2Scores(NamedTuple):
    """The full (unsorted) per-destination score table — what
    :func:`c2_scores` computes over any Queryable, including an
    in-memory windowed sub-Assoc.  :func:`detect_c2` is a sort + top-k
    view of this; the streaming beacon detector thresholds it per
    window instead of rescanning a table."""
    hosts: np.ndarray          # every dst key seen (stripped of prefix)
    scores: np.ndarray
    fanin: np.ndarray
    regularity: np.ndarray
    port_conc: np.ndarray

    to_dict = JsonReportMixin.to_dict
    to_json = JsonReportMixin.to_json
    from_dict = classmethod(JsonReportMixin.from_dict.__func__)


class ScanReport(NamedTuple):
    """``scan_detect`` hits plus the threshold they cleared — the
    JSON-serializable shape the gateway's ``/v1/scanners`` route ships."""
    hosts: np.ndarray          # scanner src IPs
    min_fanout: int

    to_dict = JsonReportMixin.to_dict
    to_json = JsonReportMixin.to_json
    from_dict = classmethod(JsonReportMixin.from_dict.__func__)


def _strip(keys: np.ndarray, prefix: str) -> np.ndarray:
    n = len(prefix)
    return np.asarray([k[n:] for k in keys], dtype=str)


def _keymap(sub: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Positions of ``sub`` keys in sorted ``target``; -1 when absent."""
    if target.shape[0] == 0 or sub.shape[0] == 0:
        return np.full(sub.shape[0], -1, np.int64)
    pos = np.clip(np.searchsorted(target, sub), 0, target.shape[0] - 1)
    return np.where(target[pos] == sub, pos, -1).astype(np.int64)


def _fuse(fanin, regularity, port_conc, total_pkts):
    """Product fusion: a C2 host must exhibit *all three* fingerprints
    (fan-in, periodicity, port concentration); any single strong signal
    in the power-law background is not enough.  Port concentration is
    squared — it is the most discriminative feature (C2 at 0.7-0.9 vs
    about 0.17 for mixed-service background hosts; see the sensitivity
    ablation in EXPERIMENTS.md)."""
    del total_pkts   # significance damping measured net-negative (ablation)
    return torch.log1p(fanin) * regularity * port_conc * port_conc


def c2_scores(E: Queryable, sep: str = "|") -> C2Scores:
    """The fused detector's scoring core over *any* Queryable — a live
    :class:`DBTable`, a deferred :class:`LazyAssoc`, or an in-memory
    windowed sub-:class:`Assoc` (the streaming path: the rollup hands a
    window slice straight to this, no table rescan).  Returns the whole
    score table, unsorted."""
    with _span("analytics.c2_scores"):
        return _c2_scores(E, sep)


def _c2_scores(E: Queryable, sep: str) -> C2Scores:
    Edst = E[:, StartsWith(f"ip.dst{sep}")]
    Esrc = E[:, StartsWith(f"ip.src{sep}")]
    Etime = E[:, StartsWith(f"frame.time{sep}")]
    Eport = E[:, StartsWith(f"tcp.dstport{sep}")]

    # unique-source fan-in: (src × dst) support, column sums of spones
    with _span("analytics.c2.fanin"):
        SD = Esrc.T * Edst                   # src × dst packet counts
        fanin_a = SD.logical().sum(0)        # 1 × dst: distinct sources
        dst_keys = _strip(fanin_a.col, f"ip.dst{sep}")
        fanin = np.zeros(dst_keys.shape[0])
        _, c, v = fanin_a.triples()
        fanin[np.searchsorted(fanin_a.col, c)] = np.asarray(v, np.float64)

    # source-uniformity: bots all contact the C2 a similar number of
    # times (duration/period each), while a popular host's sources have
    # heavy-tailed counts — CV over per-source counts separates them
    # even when beacons are too slow for time-bucket regularity.
    with _span("analytics.c2.uniform"):
        src_uniform = np.zeros(dst_keys.shape[0])
        r_sd, c_sd, v_sd = SD.triples()
        v_sd = np.asarray(v_sd, np.float64)
        if r_sd.shape[0]:
            uniq_d, inv_d = np.unique(c_sd, return_inverse=True)
            cnt = np.bincount(inv_d)
            s1 = np.bincount(inv_d, weights=v_sd)
            s2 = np.bincount(inv_d, weights=v_sd * v_sd)
            mean = s1 / cnt
            var = np.maximum(s2 / cnt - mean ** 2, 0.0)
            cv_s = np.sqrt(var) / np.maximum(mean, 1e-9)
            pos = _keymap(_strip(uniq_d, f"ip.dst{sep}"), dst_keys)
            ok = pos >= 0
            # only meaningful with several sources and repeated contacts
            score_s = np.exp(-cv_s) * (cnt >= 4) * (mean >= 2)
            src_uniform[pos[ok]] = score_s[ok]

    # beacon regularity: dst × time-bucket contact counts
    with _span("analytics.c2.beacon"):
        DT = Edst.T * Etime                  # dst × seconds
        support = np.zeros(dst_keys.shape[0])
        cv = np.ones(dst_keys.shape[0]) * 10.0   # high CV = irregular
        r, c, v = DT.triples()
        v = np.asarray(v, np.float64)
        if r.shape[0]:
            uniq, inv = np.unique(r, return_inverse=True)
            cnt = np.bincount(inv)
            s1 = np.bincount(inv, weights=v)
            s2 = np.bincount(inv, weights=v * v)
            mean = s1 / cnt
            var = np.maximum(s2 / cnt - mean ** 2, 0.0)
            cv_u = np.sqrt(var) / np.maximum(mean, 1e-9)
            pos = _keymap(_strip(uniq, f"ip.dst{sep}"), dst_keys)
            ok = pos >= 0
            support[pos[ok]] = cnt[ok]
            cv[pos[ok]] = cv_u[ok]
        # regular = contacted in many buckets with near-constant rate;
        # slow beacons (period ≫ bucket) are caught by source-uniformity
        total_buckets = max(len(DT.col), 1)
        regularity = np.maximum((support / total_buckets) * np.exp(-cv),
                                src_uniform)

    # port concentration: dst × port counts, Herfindahl index
    with _span("analytics.c2.ports"):
        DP = Edst.T * Eport
        conc = np.zeros(dst_keys.shape[0])
        total_pkts = np.zeros(dst_keys.shape[0])
        r, c, v = DP.triples()
        v = np.asarray(v, np.float64)
        if r.shape[0]:
            uniq, inv = np.unique(r, return_inverse=True)
            tot = np.bincount(inv, weights=v)
            h = np.bincount(inv, weights=v * v) / np.maximum(tot ** 2, 1e-9)
            pos = _keymap(_strip(uniq, f"ip.dst{sep}"), dst_keys)
            ok = pos >= 0
            conc[pos[ok]] = h[ok]
            total_pkts[pos[ok]] = tot[ok]

    with _span("analytics.c2.fuse"):
        fused = _fuse(to_device(fanin, torch.float32),
                      to_device(regularity, torch.float32),
                      to_device(conc, torch.float32),
                      to_device(total_pkts, torch.float32)).cpu().numpy()
    return C2Scores(dst_keys, fused, fanin, regularity, conc)


def detect_c2(E: Queryable, sep: str = "|", top_k: int = 10) -> C2Report:
    """Run the fused detector over an incidence matrix (stage-5 output)
    or directly over the database through a :class:`DBTable` binding."""
    s = c2_scores(E, sep=sep)
    order = np.argsort(s.scores)[::-1][:top_k]
    return C2Report(s.hosts[order], s.scores[order], s.fanin[order],
                    s.regularity[order], s.port_conc[order])


def scan_hits(E: Queryable, sep: str = "|",
              min_fanout: int = 32) -> np.ndarray:
    """Scan-detector scoring core: sources touching at least
    ``min_fanout`` distinct dsts with single packets (logical out-degree
    ≈ packet out-degree).  Like :func:`c2_scores`, accepts an in-memory
    windowed sub-Assoc — the streaming burst detector calls this on each
    closed window's slice."""
    Esrc = E[:, StartsWith(f"ip.src{sep}")]
    Edst = E[:, StartsWith(f"ip.dst{sep}")]
    SD = Esrc.T * Edst
    uniq_out = SD.logical().sum(1)
    pkt_out = SD.sum(1)
    r1, _, v1 = uniq_out.triples()
    r2, _, v2 = pkt_out.triples()
    v2_by_key = dict(zip(r2, np.asarray(v2, np.float64)))
    hits = []
    for k, u in zip(r1, np.asarray(v1, np.float64)):
        if u >= min_fanout and u / max(v2_by_key.get(k, 1.0), 1.0) > 0.9:
            hits.append(k[len(f"ip.src{sep}"):])
    return np.asarray(hits, dtype=str)


def scan_detect(E: Queryable, sep: str = "|",
                min_fanout: int = 32) -> np.ndarray:
    """Port/host-scan detector (see :func:`scan_hits` for the core)."""
    return scan_hits(E, sep=sep, min_fanout=min_fanout)


def scan_report(E: Queryable, sep: str = "|",
                min_fanout: int = 32) -> ScanReport:
    """:func:`scan_detect` wrapped in the JSON-serializable report shape."""
    return ScanReport(scan_detect(E, sep=sep, min_fanout=min_fanout),
                      min_fanout)
