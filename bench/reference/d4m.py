"""Plain reference of the D4M answers the benchmark checks.

Everything here is rebuilt from the packet records that the harness made
from ``--seed`` (the same records the program was handed, as TSV or as
capture files): the incidence matrix's keys, the degree table, the
rank-size fit, the fused C2 scores, PageRank, the matvec chains, the
degree histogram, the top-k and scan answers, and the pipeline's stored
entries.  It is NumPy for keys and counts and plain PyTorch on the CPU
for the arithmetic, and it imports nothing of the program.

``dtype`` is the precision of the arithmetic: ``torch.float64`` for the
reference itself, ``torch.bfloat16`` for the control that stands in for
a program computing below the float32 its configuration states.
Integer counts (degrees, fan-in, pair counts) are exact in both; the
control rounds them where it casts them to ``dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64

def ip_strings(ips: np.ndarray) -> np.ndarray:
    """Dotted quads of uint32 addresses, one Python format a unique
    address (a window holds a few thousand)."""
    ips = np.asarray(ips, np.uint32)
    uniq, inv = np.unique(ips, return_inverse=True)
    s = np.asarray([f"{u >> 24 & 255}.{u >> 16 & 255}.{u >> 8 & 255}."
                    f"{u & 255}" for u in uniq.tolist()], dtype=str)
    return s[inv]


def _t(x, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64)).to(dtype)


def _coded(keys: np.ndarray):
    """(sorted unique keys, code of each element)."""
    return np.unique(keys, return_inverse=True)


class Window:
    """One ingested window's packets, as the reference sees them: the
    field strings of each packet under the paper's schema, with row ``i``
    keyed ``f"{i:09d}"`` (the TSV's id column)."""

    def __init__(self, rec: np.ndarray):
        self.n = int(rec.shape[0])
        self.src = ip_strings(rec["src"])
        self.dst = ip_strings(rec["dst"])
        ts = rec["ts_sec"].astype(np.float64) + rec["ts_usec"] * 1e-6
        self.time = np.char.mod("%.6f", ts)
        self.dport = rec["dport"].astype(np.int64)
        self.dst_keys, self.dst_code = _coded(self.dst)
        self.src_keys, self.src_code = _coded(self.src)
        self.time_keys, self.time_code = _coded(self.time)
        self.port_keys, self.port_code = _coded(self.dport)
        self.dst_deg = np.bincount(self.dst_code,
                                   minlength=self.dst_keys.shape[0])
        self.src_deg = np.bincount(self.src_code,
                                   minlength=self.src_keys.shape[0])

    # -- degree table -------------------------------------------------------
    def degrees(self, prefix: str) -> tuple[np.ndarray, np.ndarray]:
        """TedgeDeg under ``ip.dst|`` or ``ip.src|``: (bare keys sorted,
        packet counts)."""
        if prefix == "ip.dst|":
            return self.dst_keys, self.dst_deg
        if prefix == "ip.src|":
            return self.src_keys, self.src_deg
        raise ValueError(f"no reference degrees under {prefix!r}")

    # -- chains --------------------------------------------------------------
    def indicator_chain(self, host: str):
        """``T * x_h`` with x_h one at ``ip.dst|h`` and ``ip.src|h``:
        (packet indices, counts), exact integers."""
        v = (self.dst == host).astype(np.int64) + (self.src == host)
        idx = np.flatnonzero(v)
        return idx, v[idx].astype(np.float64)

    def degree_chain(self, dtype=F64):
        """``T * deg`` with deg the ``ip.dst|`` degrees: each packet's
        destination degree, cast to ``dtype`` (one term a row)."""
        deg = _t(self.dst_deg, dtype)
        out = torch.zeros(self.n, dtype=dtype).index_add_(
            0, torch.arange(self.n), deg[torch.as_tensor(self.dst_code)])
        return np.arange(self.n), out.to(F64).numpy()

    # -- C2 ------------------------------------------------------------------
    def c2_scores(self, dtype=F64):
        """The fused detector: (bare dst keys, scores) over every
        destination, scores in ``dtype`` arithmetic."""
        nd = self.dst_keys.shape[0]
        fanin, src_uniform = self._pair_stats(self.src_code,
                                              self.src_keys.shape[0], nd)
        support, cv = self._cv(self.time_code, self.time_keys.shape[0], nd)
        total_buckets = max(self.time_keys.shape[0], 1)
        regularity = np.maximum((support / total_buckets) * np.exp(-cv),
                                src_uniform)
        conc = self._herfindahl(nd)
        f, r, c = _t(fanin, dtype), _t(regularity, dtype), _t(conc, dtype)
        score = torch.log1p(f) * r * c * c
        return self.dst_keys, score.to(F64).numpy()

    def _pair_counts(self, code: np.ndarray, n_other: int):
        """(dst code, count) of each distinct (dst, other) pair."""
        pair = self.dst_code.astype(np.int64) * n_other + code
        u, cnt = np.unique(pair, return_counts=True)
        return u // n_other, cnt.astype(np.float64)

    def _moments(self, d: np.ndarray, v: np.ndarray, nd: int):
        cnt = np.bincount(d, minlength=nd).astype(np.float64)
        s1 = np.bincount(d, weights=v, minlength=nd)
        s2 = np.bincount(d, weights=v * v, minlength=nd)
        mean = s1 / np.maximum(cnt, 1)
        var = np.maximum(s2 / np.maximum(cnt, 1) - mean ** 2, 0.0)
        return cnt, mean, np.sqrt(var) / np.maximum(mean, 1e-9)

    def _pair_stats(self, code, n_other, nd):
        d, v = self._pair_counts(code, n_other)
        cnt, mean, cv = self._moments(d, v, nd)
        uniform = np.exp(-cv) * (cnt >= 4) * (mean >= 2)
        return cnt, np.where(cnt > 0, uniform, 0.0)

    def _cv(self, code, n_other, nd):
        d, v = self._pair_counts(code, n_other)
        cnt, _, cv = self._moments(d, v, nd)
        return cnt, np.where(cnt > 0, cv, 10.0)

    def _herfindahl(self, nd):
        d, v = self._pair_counts(self.port_code, self.port_keys.shape[0])
        tot = np.bincount(d, weights=v, minlength=nd)
        sq = np.bincount(d, weights=v * v, minlength=nd)
        return sq / np.maximum(tot ** 2, 1e-9)

    # -- PageRank ------------------------------------------------------------
    def pagerank(self, num_iters: int, damping: float = 0.85, dtype=F64):
        """(node keys sorted, ranks) over the src -> dst packet-count
        adjacency, dangling mass spread uniformly."""
        nodes = np.union1d(self.src_keys, self.dst_keys)
        s = np.searchsorted(nodes, self.src_keys)[self.src_code]
        d = np.searchsorted(nodes, self.dst_keys)[self.dst_code]
        n = nodes.shape[0]
        pair, w = np.unique(s.astype(np.int64) * n + d, return_counts=True)
        rows = torch.as_tensor(pair // n)
        cols = torch.as_tensor(pair % n)
        w = _t(w, dtype)
        out_deg = torch.zeros(n, dtype=dtype).index_add_(0, rows, w)
        inv = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1e-30),
                          torch.zeros((), dtype=dtype))
        p = torch.full((n,), 1.0 / n, dtype=dtype)
        rank = p.clone()
        for _ in range(num_iters):
            contrib = rank * inv
            spread = torch.zeros(n, dtype=dtype).index_add_(
                0, cols, w * contrib[rows])
            dangling = torch.where(out_deg > 0, torch.zeros((), dtype=dtype),
                                   rank).sum()
            rank = (1 - damping) * p + damping * (spread + dangling * p)
        return nodes, rank.to(F64).numpy()

    # -- scans ---------------------------------------------------------------
    def scan_col(self, key: str):
        """Row keys of Tedge under one column key, sorted."""
        field, _, value = key.partition("|")
        col = {"ip.dst": self.dst, "ip.src": self.src}[field]
        return np.char.zfill(np.flatnonzero(col == value).astype(str), 9)


def fit_rank_size(degrees, dtype=F64) -> dict:
    """Weighted least squares of log degree on log rank, the tail
    weighted by 1 / log1p(rank): alpha, log_c and r2."""
    d = torch.sort(_t(degrees, dtype), descending=True).values
    n = d.shape[0]
    rank = torch.arange(1, n + 1, dtype=F64).to(dtype)
    zero = torch.zeros((), dtype=dtype)
    w = torch.where(d > 0, 1.0 / torch.log1p(rank), zero)
    x = torch.log(rank)
    y = torch.log(d.clamp(min=1e-9))
    wsum = w.sum()
    xm = (w * x).sum() / wsum
    ym = (w * y).sum() / wsum
    slope = (w * (x - xm) * (y - ym)).sum() / \
        (w * (x - xm) ** 2).sum().clamp(min=1e-9)
    icpt = ym - slope * xm
    resid = torch.where(d > 0, y - (icpt + slope * x), zero)
    r2 = 1.0 - (w * resid ** 2).sum() / \
        (w * (y - ym) ** 2).sum().clamp(min=1e-9)
    return {"alpha": float(-slope), "log_c": float(icpt), "r2": float(r2)}


def degree_histogram(degrees, n_bins: int, dtype=F64) -> np.ndarray:
    """Counts of log1p(degree) over ``n_bins`` equal bins from 0 to just
    above the largest."""
    logd = torch.log1p(_t(degrees, dtype).clamp(min=0))
    hi = max(float(logd.max()), 1e-6)
    edges = torch.linspace(0.0, hi * (1 + 1e-6), n_bins + 1,
                           dtype=F64).to(dtype)
    idx = (torch.searchsorted(edges, logd, right=True) - 1).clamp(
        0, n_bins - 1)
    return np.bincount(idx.numpy(), minlength=n_bins).astype(np.float64)


def pipeline_window(rec_by_file: list, split_records: int):
    """The store a pipeline pass leaves, rebuilt from each capture
    file's records: the Tedge row key of every packet, the column keys of
    its entries (one a field, ``(n, 8)``), and TedgeDeg as (sorted keys,
    counts).  Row keys are ``capture{i:04d}.split{j:05d}.pcap|{k:09d}``;
    ``frame.time`` is bucketed to whole seconds and
    ``frame.time_relative`` dropped, as the paper's sort stage
    restructures them."""
    rows, cols = [], []
    for i, rec in enumerate(rec_by_file):
        n = rec.shape[0]
        j = np.arange(n) // split_records
        k = np.arange(n) % split_records
        rows.append(np.char.add(np.char.add(np.char.add(
            f"capture{i:04d}.split", np.char.zfill(j.astype(str), 5)),
            ".pcap|"), np.char.zfill(k.astype(str), 9)))
        ts = rec["ts_sec"].astype(np.float64) + rec["ts_usec"] * 1e-6
        secs = np.char.mod("%.0f", np.char.mod("%.6f", ts).astype(
            np.float64))
        fields = {
            "frame.time": secs,
            "ip.dst": ip_strings(rec["dst"]),
            "ip.len": rec["orig_len"].astype(np.int64).astype(str),
            "ip.proto": rec["proto"].astype(np.int64).astype(str),
            "ip.src": ip_strings(rec["src"]),
            "tcp.dstport": rec["dport"].astype(np.int64).astype(str),
            "tcp.flags": np.char.mod("0x%08x",
                                     rec["off_flags"].astype(np.int64)),
            "tcp.srcport": rec["sport"].astype(np.int64).astype(str),
        }
        cols.append(np.stack([np.char.add(f + "|", v)
                              for f, v in fields.items()], axis=1))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    deg_keys, deg = [], []
    for f in range(cols.shape[1]):
        k, c = np.unique(cols[:, f], return_counts=True)
        deg_keys.append(k)
        deg.append(c)
    deg_keys, deg = np.concatenate(deg_keys), np.concatenate(deg)
    o = np.argsort(deg_keys, kind="stable")
    return rows, cols, deg_keys[o], deg[o].astype(np.float64)


def store_mismatch(rows_p: np.ndarray, cols_p: np.ndarray, code_r: np.ndarray,
                   code_c: np.ndarray, rows_w: np.ndarray,
                   cols_w: np.ndarray) -> int:
    """Entries in one store and not the other.  The program's store is
    given by its sorted row and column keys and each entry's codes into
    them; the reference's by each packet's row key and its (n, f)
    column keys."""
    rk = np.union1d(rows_p, rows_w)
    ck = np.union1d(cols_p, np.unique(cols_w))
    got = np.searchsorted(rk, rows_p)[code_r].astype(np.int64) * \
        ck.shape[0] + np.searchsorted(ck, cols_p)[code_c]
    r = np.repeat(np.searchsorted(rk, rows_w), cols_w.shape[1])
    want = r.astype(np.int64) * ck.shape[0] + \
        np.searchsorted(ck, cols_w.ravel())
    got, want = np.unique(got), np.unique(want)
    return int(np.setdiff1d(got, want).shape[0] +
               np.setdiff1d(want, got).shape[0])
