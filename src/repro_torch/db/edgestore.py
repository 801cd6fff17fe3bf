"""Sharded edge store — the Apache Accumulo analog (paper stage 6).

Accumulo is a distributed sorted key-value store; D4M's schema keeps three
tables: ``Tedge`` (packet × field|value), its transpose ``TedgeT`` (for
column queries — Accumulo only scans rows efficiently), and ``TedgeDeg``
(degree table maintained with a sum *combiner* at ingest time).  The
paper's central database finding is topological: **8 parallel 16-node
instances out-ingest one 128-node instance** because ingest throughput
scales with independent write paths while a single large instance
bottlenecks on coordination.

This module reproduces that topology faithfully:

* :class:`Tablet` — one tablet server: a sorted in-memory KV map with a
  sum-combiner degree column family and batched mutation queues.
* :class:`EdgeStore` — one Accumulo *instance*: N tablets with
  range-partitioned split points (like Accumulo tablet splits) and an
  instance-level ingest choke (models the master/coordination overhead
  that grows with instance size).
* :class:`MultiInstanceDB` — M parallel instances, hash-routed, i.e. the
  paper's "2, 4, 8 databases running in parallel each with 16 nodes".

The store is in-process (no network), but every scaling-relevant
mechanism — partitioning, combiners, batch writers, per-instance
coordination cost — is real, so the *shape* of the paper's Fig. 5 ingest
curve is reproducible (see benchmarks/bench_ingest.py).
"""
from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Iterable, Optional, Sequence

import numpy as np

from ..core.assoc import Assoc


def connections_query(store, ip: str, fields=("ip.src", "ip.dst"),
                      sep: str = "|") -> dict[str, float]:
    """Fig. 2's query served *from the database*: packets touching
    ``ip`` → histogram of their other endpoints.  Works on any store
    exposing the ``row()``/``col()`` point-query protocol (EdgeStore,
    LSMStore, ...)."""
    out: defaultdict[str, float] = defaultdict(float)
    for field in fields:
        for pkt in store.col(f"{field}{sep}{ip}"):
            for ck in store.row(pkt):
                if ck.startswith("ip.src" + sep) or \
                        ck.startswith("ip.dst" + sep):
                    other = ck.split(sep, 1)[1]
                    if other != ip:
                        out[other] += 1.0
    return dict(out)


def _warn_query_deprecated(name: str) -> None:
    import warnings
    warnings.warn(
        f"EdgeStore.{name} is deprecated; query through the D4M binding "
        f"(repro_torch.db.DB / DBTable subscripts) instead.",
        DeprecationWarning, stacklevel=3)


class Tablet:
    """One tablet server: sorted KV with sum-combiner degree support."""

    def __init__(self, tablet_id: str):
        self.tablet_id = tablet_id
        self._rows: dict[str, dict[str, str]] = {}
        self._sorted_keys: list[str] = []
        self._deg: defaultdict[str, float] = defaultdict(float)
        self._lock = threading.Lock()
        self.n_mutations = 0
        self.ingest_bytes = 0

    def mutate(self, rows: Sequence[str], cols: Sequence[str],
               vals: Sequence[str]) -> int:
        """Apply a batch of (row, col, val) mutations."""
        with self._lock:
            for r, c, v in zip(rows, cols, vals):
                cells = self._rows.get(r)
                if cells is None:
                    cells = self._rows[r] = {}
                    bisect.insort(self._sorted_keys, r)
                cells[c] = v
                self.n_mutations += 1
                self.ingest_bytes += len(r) + len(c) + len(v)
        return len(rows)

    def combine_degree(self, keys: Sequence[str], counts: Sequence[float]):
        """Sum-combiner column update (TedgeDeg maintenance)."""
        with self._lock:
            for k, n in zip(keys, counts):
                self._deg[k] += float(n)

    def scan_row(self, row: str) -> dict[str, str]:
        return dict(self._rows.get(row, {}))

    def scan_range(self, start: str, stop: str) -> Iterable[tuple[str, dict]]:
        for k in self.keys_in_range(start, stop):
            yield k, dict(self._rows[k])

    def degree(self, key: str) -> float:
        return self._deg.get(key, 0.0)

    def scan_all(self) -> Iterable[tuple[str, dict]]:
        """Full tablet scan in key order."""
        for k in self._sorted_keys:
            yield k, dict(self._rows[k])

    def keys_in_range(self, start: str, stop: str) -> list[str]:
        lo = bisect.bisect_left(self._sorted_keys, start)
        hi = bisect.bisect_right(self._sorted_keys, stop)
        return self._sorted_keys[lo:hi]

    @property
    def n_rows(self) -> int:
        return len(self._rows)


class EdgeStore:
    """One Accumulo instance: Tedge + TedgeT + TedgeDeg over N tablets.

    ``coordination_cost_s`` models the per-batch master overhead that
    grows with instance size — the mechanism behind the paper's
    8×16 > 1×128 observation.  Set to 0 for pure in-process benchmarking.
    """

    def __init__(self, n_tablets: int = 16, name: str = "db0",
                 coordination_cost_s: float = 0.0):
        self.name = name
        self.n_tablets = n_tablets
        self.tablets = [Tablet(f"{name}/t{i:03d}") for i in range(n_tablets)]
        self.tablets_t = [Tablet(f"{name}/tT{i:03d}") for i in range(n_tablets)]
        self.coordination_cost_s = coordination_cost_s
        self._lock = threading.Lock()

    # -- routing ----------------------------------------------------------
    def _route(self, keys: np.ndarray) -> np.ndarray:
        """Stable hash-partition of row keys onto tablets."""
        h = np.asarray([hash(k) for k in keys], dtype=np.int64)
        return np.abs(h) % self.n_tablets

    # -- ingest (the paper's `put(Tedge, putVal(E,'1,'))`) -----------------
    def put(self, E: Assoc) -> int:
        """Insert an incidence matrix: Tedge + transpose + degree table."""
        r, c, v = E.triples()
        return self.put_triples(r, c, np.asarray(v).astype(str))

    def put_triples(self, r: np.ndarray, c: np.ndarray,
                    v: np.ndarray) -> int:
        """Raw triple mutation batch (the binding layer's batched-writer
        entry point — skips Assoc construction on the write path)."""
        import time
        cache = getattr(self, "_scan_cache", None)
        if cache is not None:   # evict cached bands this batch touches
            cache.note_write(r, c)
        if self.coordination_cost_s:
            time.sleep(self.coordination_cost_s * self.n_tablets / 16.0)
        # Tedge (row-keyed)
        t_ids = self._route(r)
        for t in np.unique(t_ids):
            m = t_ids == t
            self.tablets[t].mutate(r[m], c[m], v[m])
        # TedgeT (column-keyed — enables Fig. 2 queries)
        t_ids = self._route(c)
        for t in np.unique(t_ids):
            m = t_ids == t
            self.tablets_t[t].mutate(c[m], r[m], v[m])
        # TedgeDeg via sum combiner
        keys, counts = np.unique(c, return_counts=True)
        t_ids = self._route(keys)
        for t in np.unique(t_ids):
            m = t_ids == t
            self.tablets[t].combine_degree(keys[m], counts[m])
        return int(r.shape[0])

    def put_degree(self, Edeg: Assoc) -> int:
        """Explicit degree-table insert (paper: put(TedgeDeg, num2str(Edeg)))."""
        r, _, v = Edeg.triples()
        keys = np.asarray(r, dtype=str)
        counts = np.asarray(v, dtype=np.float64)
        cache = getattr(self, "_scan_cache", None)
        if cache is not None:   # degree bands are keyed by column keys
            cache.note_write(np.asarray([], dtype=str), keys)
        t_ids = self._route(keys)
        for t in np.unique(t_ids):
            m = t_ids == t
            self.tablets[t].combine_degree(keys[m], counts[m])
        return int(keys.shape[0])

    # -- queries ------------------------------------------------------------
    def row(self, row_key: str) -> dict[str, str]:
        return self.tablets[self._route(np.asarray([row_key]))[0]] \
            .scan_row(row_key)

    def col(self, col_key: str) -> dict[str, str]:
        """All row keys bearing ``col_key`` — via the transpose table."""
        return self.tablets_t[self._route(np.asarray([col_key]))[0]] \
            .scan_row(col_key)

    # -- binding-layer scans (repro_torch.db.binding routes through these) -------
    def _table(self, transpose: bool) -> list[Tablet]:
        return self.tablets_t if transpose else self.tablets

    def scan_keys(self, keys: Sequence[str], transpose: bool = False):
        """Yield (key, cells) in key order for the given Tedge/TedgeT
        row keys (sorted so instance streams merge without buffering)."""
        tabs = self._table(transpose)
        uniq = sorted(set(keys))
        if uniq:
            for key, t in zip(uniq, self._route(np.asarray(uniq, dtype=str))):
                cells = tabs[t].scan_row(key)
                if cells:
                    yield key, cells

    def scan_key_range(self, start: str, stop: str,
                       transpose: bool = False):
        """Yield (key, cells) in key order for the inclusive [start, stop]
        range — every tablet holds a sorted shard (a key lives in exactly
        one tablet), so a k-way merge over the N tablet range scans
        streams the result (Accumulo's tablet-parallel scan pattern)."""
        import heapq
        yield from heapq.merge(
            *(t.scan_range(start, stop) for t in self._table(transpose)),
            key=lambda kv: kv[0])

    def scan_prefix(self, prefix: str, transpose: bool = False):
        yield from self.scan_key_range(prefix, prefix + "￿",
                                       transpose=transpose)

    def scan_everything(self, transpose: bool = False):
        import heapq
        yield from heapq.merge(
            *(t.scan_all() for t in self._table(transpose)),
            key=lambda kv: kv[0])

    def keys_with_prefix(self, prefix: str,
                         transpose: bool = True) -> list[str]:
        """Enumerate stored keys under ``prefix`` (degree-guard probe)."""
        out: list[str] = []
        for t in self._table(transpose):
            out.extend(t.keys_in_range(prefix, prefix + "￿"))
        return out

    def degree_items(self, prefix: str = ""):
        """Yield (col_key, degree) pairs from TedgeDeg, optionally
        restricted to a key prefix."""
        for t in self.tablets:
            for k, v in t._deg.items():
                if not prefix or k.startswith(prefix):
                    yield k, v

    # -- deprecated pre-binding query surface ------------------------------
    def query_row(self, row_key: str) -> dict[str, str]:
        """Deprecated: use ``DB(...)`` / ``DBTable[row_key, :]``."""
        _warn_query_deprecated("query_row")
        return self.row(row_key)

    def query_col(self, col_key: str) -> dict[str, str]:
        """Deprecated: use ``DBTable[:, col_key]``."""
        _warn_query_deprecated("query_col")
        return self.col(col_key)

    def query_degree(self, col_key: str) -> float:
        """Deprecated: use ``DBTable.degree(col_key)``."""
        _warn_query_deprecated("query_degree")
        return self.degree(col_key)

    def degree(self, col_key: str) -> float:
        return self.tablets[self._route(np.asarray([col_key]))[0]] \
            .degree(col_key)

    def degree_assoc(self) -> Assoc:
        """Materialize TedgeDeg as an Assoc (for analytics)."""
        keys, vals = [], []
        for t in self.tablets:
            for k, vv in t._deg.items():
                keys.append(k)
                vals.append(vv)
        if not keys:
            return Assoc()
        return Assoc(np.asarray(keys, dtype=str), "degree,",
                     np.asarray(vals))

    def connections(self, ip: str, **kw) -> dict[str, float]:
        return connections_query(self, ip, **kw)

    # -- stats --------------------------------------------------------------
    @property
    def n_entries(self) -> int:
        return sum(t.n_mutations for t in self.tablets)

    @property
    def ingest_bytes(self) -> int:
        return sum(t.ingest_bytes for t in self.tablets) + \
            sum(t.ingest_bytes for t in self.tablets_t)


class MultiInstanceDB:
    """M parallel EdgeStore instances (the paper's winning topology)."""

    def __init__(self, n_instances: int = 8, tablets_per_instance: int = 16,
                 coordination_cost_s: float = 0.0):
        self.instances = [
            EdgeStore(tablets_per_instance, name=f"db{i}",
                      coordination_cost_s=coordination_cost_s)
            for i in range(n_instances)]

    @staticmethod
    def key_hash(k: str) -> int:
        """Row/file → instance hash.  Process-salted is fine here (the
        store is volatile); durable subclasses must override with a
        stable hash — instance placement outlives the process there."""
        return abs(hash(k))

    def route(self, file_id: str):
        return self.instances[self.key_hash(file_id) % len(self.instances)]

    def put(self, E: Assoc, file_id: str = "") -> int:
        return self.route(file_id).put(E)

    def put_triples(self, r: np.ndarray, c: np.ndarray,
                    v: np.ndarray) -> int:
        """Row-hash partition a triple batch across instances — the
        independent parallel write paths behind the paper's 8×16 > 1×128
        ingest finding, without tying a whole file to one instance."""
        if not len(r):
            return 0
        h = np.asarray([self.key_hash(k) for k in r], dtype=np.int64)
        part = h % len(self.instances)
        n = 0
        for i in np.unique(part):
            m = part == i
            n += self.instances[i].put_triples(r[m], c[m], v[m])
        return n

    # -- binding-layer scans (instance fan-out + merge) --------------------
    def scan_keys(self, keys, transpose: bool = False):
        yield from self._merged(lambda inst: inst.scan_keys(
            keys, transpose=transpose))

    def scan_key_range(self, start: str, stop: str, transpose: bool = False):
        yield from self._merged(lambda inst: inst.scan_key_range(
            start, stop, transpose=transpose))

    def scan_prefix(self, prefix: str, transpose: bool = False):
        yield from self._merged(lambda inst: inst.scan_prefix(
            prefix, transpose=transpose))

    def scan_everything(self, transpose: bool = False):
        yield from self._merged(lambda inst: inst.scan_everything(
            transpose=transpose))

    def _merged(self, scan):
        """Fan a scan out over all instances, merging cells per key (a
        key's entries may be spread across instances by batch routing).
        Instance streams are key-sorted, so this is a streaming k-way
        merge — no full-result buffering on large scans."""
        import heapq
        cur_key = None
        cur_cells: dict[str, str] = {}
        for k, cells in heapq.merge(*(scan(inst) for inst in self.instances),
                                    key=lambda kv: kv[0]):
            if k == cur_key:
                cur_cells.update(cells)
            else:
                if cur_key is not None:
                    yield cur_key, cur_cells
                cur_key, cur_cells = k, dict(cells)
        if cur_key is not None:
            yield cur_key, cur_cells

    def keys_with_prefix(self, prefix: str, transpose: bool = True):
        out: set[str] = set()
        for inst in self.instances:
            out.update(inst.keys_with_prefix(prefix, transpose=transpose))
        return sorted(out)

    def degree_items(self, prefix: str = ""):
        acc: defaultdict[str, float] = defaultdict(float)
        for inst in self.instances:
            for k, v in inst.degree_items(prefix):
                acc[k] += v
        return iter(acc.items())

    def query_row(self, row_key: str) -> dict[str, str]:
        """Deprecated: use ``DBTable[row_key, :]``."""
        _warn_query_deprecated("query_row")
        out: dict[str, str] = {}
        for inst in self.instances:
            out.update(inst.row(row_key))
        return out

    def query_col(self, col_key: str) -> dict[str, str]:
        """Deprecated: use ``DBTable[:, col_key]``."""
        _warn_query_deprecated("query_col")
        out: dict[str, str] = {}
        for inst in self.instances:
            out.update(inst.col(col_key))
        return out

    def query_degree(self, col_key: str) -> float:
        """Deprecated: use ``DBTable.degree(col_key)``."""
        _warn_query_deprecated("query_degree")
        return self.degree(col_key)

    def degree(self, col_key: str) -> float:
        return sum(inst.degree(col_key) for inst in self.instances)

    def connections(self, ip: str, **kw) -> dict[str, float]:
        out: defaultdict[str, float] = defaultdict(float)
        for inst in self.instances:
            for k, v in inst.connections(ip, **kw).items():
                out[k] += v
        return dict(out)

    def degree_assoc(self) -> Assoc:
        out = Assoc()
        for inst in self.instances:
            out = out + inst.degree_assoc()
        return out

    @property
    def n_entries(self) -> int:
        return sum(i.n_entries for i in self.instances)
