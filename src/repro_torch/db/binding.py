"""The D4M database binding: tables *are* associative arrays.

The paper's whole productivity claim (§IV-G, the 135-line pipeline) rests
on one API idea::

    T = DB('Tedge', 'TedgeT', 'TedgeDeg')   # bind the table triple
    put(T, putval(E, '1,'))                  # ingest an incidence matrix
    A = T[:, 'ip.dst|1.1.1.1,']              # Fig. 2 query — an Assoc

A :class:`DBTable` speaks the full :class:`~repro_torch.core.assoc.Assoc`
selection grammar — key lists ``'a,b,'``, ranges ``'a,:,b,'``, prefixes
``'ip.src|*,'`` / :class:`StartsWith`, ``:`` — and routes each subscript
to the physically right table:

* row subscripts scan **Tedge** (Accumulo scans rows efficiently);
* column subscripts scan the transpose table **TedgeT**;
* column queries first consult **TedgeDeg**, the combiner-maintained
  degree table, when a ``degree_limit`` is set — the paper's guard
  against *accidental densification* (subscripting a super-node column
  would otherwise materialize a near-dense result).

Subscripts return :class:`~repro_torch.core.expr.LazyAssoc` nodes, so chains of
algebra over table queries build one operator DAG: the planner pushes the
selection down into the tablet scan and fuses the elementwise stages
(see ``repro_torch.core.expr``).  ``put`` replaces direct tablet mutation with
batched writers that keep every :class:`MultiInstanceDB` instance's write
path busy — the paper's parallel-instance ingest topology — and with
``sync=False`` enqueues to the backend's async
:class:`~repro_torch.db.writer.WriterPool` (writes visible at the next
``flush()``, which every binding read issues automatically).  Hot scans
are served from a per-backend :class:`ScanCache` (TTL + write-path
invalidation); see docs/api.md "Performance".
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from collections import deque
from typing import Iterable, Optional, Sequence, Union

import numpy as np

from ..core import keys as K
from ..core.assoc import Assoc
from ..core.expr import LazyAssoc, _is_all, _sel_key
from ..obs.metrics import REGISTRY as _REGISTRY, obj_label as _obj_label
from ..obs.trace import span as _span
from .edgestore import EdgeStore, MultiInstanceDB
from .lsmstore import LSMMultiInstanceDB, LSMStore
from .registry import make_backend
from .writer import AsyncWriterError, WriterPool

Backend = Union[EdgeStore, MultiInstanceDB, LSMStore, LSMMultiInstanceDB]

_KNOWN_TABLES = ("Tedge", "TedgeT", "TedgeDeg")

# Default TTL (seconds) for the binding-layer scan cache; 0 disables.
DEFAULT_SCAN_TTL = 60.0

# Default writes/sec above which full-table ('any'-band) scan results are
# not admitted to the cache — they are evicted by any write and churn.
DEFAULT_FULL_SCAN_WPS_LIMIT = 50.0

# Scan-cache metric families: one labeled child per live ScanCache (the
# cache keeps the only strong ref; see repro_torch.obs.metrics).  The cache's
# public hits/misses/… attributes are properties over these children, so
# /metrics and T.stats() report the same underlying counts.
_M_CACHE_HITS = _REGISTRY.counter(
    "repro_cache_hits_total", "ScanCache lookups served from memory",
    labels=("cache",))
_M_CACHE_MISSES = _REGISTRY.counter(
    "repro_cache_misses_total", "ScanCache lookups that hit the tablets",
    labels=("cache",))
_M_CACHE_EVICTIONS = _REGISTRY.counter(
    "repro_cache_evictions_total",
    "ScanCache entries evicted (TTL, capacity, write invalidation)",
    labels=("cache",))
_M_CACHE_ADMISSION_SKIPS = _REGISTRY.counter(
    "repro_cache_admission_skips_total",
    "Full-table scan results refused admission under write load",
    labels=("cache",))
_M_CACHE_BATCH_HITS = _REGISTRY.counter(
    "repro_cache_batch_hits_total",
    "Batched-eval members served from the ScanCache", labels=("cache",))
_M_CACHE_BATCH_MISSES = _REGISTRY.counter(
    "repro_cache_batch_misses_total",
    "Batched-eval members that joined a union tablet scan",
    labels=("cache",))


class AccidentalDenseError(RuntimeError):
    """A column query would materialize a super-node block.

    Raised when a subscript's column keys have combined TedgeDeg degree
    above the table's ``degree_limit``.  Re-issue with a tighter selector,
    or bind with a higher/absent limit (``T.with_degree_limit(None)``).
    """

    def __init__(self, offenders: list[tuple[str, float]], limit: float):
        self.offenders = offenders
        self.limit = limit
        worst = ", ".join(f"{k} (deg={v:g})" for k, v in offenders[:5])
        super().__init__(
            f"column query exceeds degree_limit={limit:g}: {worst}"
            + (" …" if len(offenders) > 5 else ""))


# ---------------------------------------------------------------------------
# Selector classification — one grammar, three physical routes.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Atoms:
    """A selector normalized to scan units: exact keys, prefixes, or a
    single inclusive range; ``kind == 'all'`` means the full axis."""
    kind: str                       # 'all' | 'atoms' | 'range'
    keys: tuple = ()
    prefixes: tuple = ()
    range: Optional[tuple] = None   # (start, stop)


def _classify(sel) -> _Atoms:
    if _is_all(sel):
        return _Atoms("all")
    if isinstance(sel, np.ndarray) and sel.dtype.kind in "biu":
        raise TypeError(
            "boolean/integer positional selectors are meaningless against "
            "a database table — subscript with keys, ranges, or prefixes")
    if isinstance(sel, K.StartsWith):
        return _Atoms("atoms", prefixes=(sel.prefix,))
    if isinstance(sel, K.KeyRange):
        return _Atoms("range", range=(sel.start, sel.stop))
    if isinstance(sel, str):
        parts = K.parse_keys(sel)
        if parts.shape[0] == 3 and parts[1] == ":":
            return _Atoms("range", range=(str(parts[0]), str(parts[2])))
    else:
        parts = K.parse_keys(sel)
    keys, prefixes = [], []
    for p in parts:
        p = str(p)
        (prefixes if p.endswith("*") else keys).append(
            p[:-1] if p.endswith("*") else p)
    return _Atoms("atoms", keys=tuple(keys), prefixes=tuple(prefixes))


# ---------------------------------------------------------------------------
# TTL scan cache — hot column bands served without re-hitting tablets.
# ---------------------------------------------------------------------------

class ScanCache:
    """Binding-layer cache of table scans, keyed by the planner's
    structural scan key (the same identity ``repro_torch.core.expr._skey`` uses
    for CSE), so a repeated hot band — ``T[:, 'ip.dst|*,']`` issued by
    every analyst — is served from memory across *separate* expression
    DAGs, not just within one.

    Coherence comes from two mechanisms:

    * **write-path invalidation** — every ``put`` through the binding (or
      directly through an attached store) calls :meth:`note_write`; any
      cached entry whose scanned band intersects the written keys is
      evicted *before* the mutation lands;
    * **TTL** — entries expire ``ttl`` seconds after insertion, bounding
      staleness against writers that bypass the store entirely.

    One cache is shared per backend (all :class:`DBTable` views of a
    store see the same entries); cached ``Assoc`` results are shared by
    reference and must be treated as immutable — the same contract the
    lazy executor's memoization already imposes.
    """

    def __init__(self, ttl: float = DEFAULT_SCAN_TTL, maxsize: int = 128,
                 clock=time.monotonic,
                 full_scan_wps_limit: float = DEFAULT_FULL_SCAN_WPS_LIMIT,
                 wps_window: float = 10.0):
        self.ttl = ttl
        self.maxsize = maxsize
        self.clock = clock
        # admission policy for 'any'-band (full-table) entries: they are
        # evicted by *any* write, so on a write-heavy backend caching
        # them is pure churn.  When the observed write rate exceeds
        # ``full_scan_wps_limit`` writes/s (over ``wps_window`` seconds),
        # full-table scans are not admitted.
        self.full_scan_wps_limit = full_scan_wps_limit
        self.wps_window = wps_window
        self._write_times: deque = deque(maxlen=1024)
        # skey → (assoc, expiry, axis, atoms); insertion-ordered for
        # oldest-first eviction when full.
        self._entries: dict = {}
        self._lock = threading.RLock()
        # bumped on every write; admission is gated on it so a scan that
        # raced a concurrent write cannot re-populate the cache with a
        # pre-write result (the write's note_write ran before the scan
        # finished, when the entry wasn't there to evict)
        self.version = 0
        # counters live in the process registry (one labeled child per
        # cache); hits/misses/… below read them back, so /metrics and
        # stats() can never disagree.  batch_* are the batch-path probes
        # (a subset of hits/misses): how often a batched eval was served
        # by / had to populate per-member entries.
        self.metrics_label = _obj_label("cache")
        lab = dict(cache=self.metrics_label)
        self._m_hits = _M_CACHE_HITS.labels(**lab)
        self._m_misses = _M_CACHE_MISSES.labels(**lab)
        self._m_evictions = _M_CACHE_EVICTIONS.labels(**lab)
        self._m_admission_skips = _M_CACHE_ADMISSION_SKIPS.labels(**lab)
        self._m_batch_hits = _M_CACHE_BATCH_HITS.labels(**lab)
        self._m_batch_misses = _M_CACHE_BATCH_MISSES.labels(**lab)

    # registry-backed counter reads (compat: pre-obs attribute shapes)
    @property
    def hits(self):
        return self._m_hits.value

    @property
    def misses(self):
        return self._m_misses.value

    @property
    def evictions(self):
        return self._m_evictions.value

    @property
    def admission_skips(self):
        return self._m_admission_skips.value

    @property
    def batch_hits(self):
        return self._m_batch_hits.value

    @property
    def batch_misses(self):
        return self._m_batch_misses.value

    def get(self, key) -> Optional[Assoc]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self._m_misses.inc()
                return None
            assoc, expiry, _, _ = hit
            if self.clock() > expiry:
                del self._entries[key]
                self._m_evictions.inc()
                self._m_misses.inc()
                return None
            self._m_hits.inc()
            return assoc

    def put(self, key, assoc: Assoc, axis: str, atoms: _Atoms,
            ttl: Optional[float] = None,
            if_version: Optional[int] = None) -> None:
        """Admit a scan result.  ``ttl`` overrides the cache default (the
        inserting view's knob); ``if_version`` skips admission when any
        write landed since the caller captured :attr:`version` (i.e. the
        scan may predate that write)."""
        ttl = self.ttl if ttl is None else ttl
        if ttl <= 0:
            return
        with self._lock:
            if if_version is not None and self.version != if_version:
                return
            if axis == "any" and \
                    self._writes_per_s_locked() > self.full_scan_wps_limit:
                self._m_admission_skips.inc()
                return
            while len(self._entries) >= self.maxsize:
                self._entries.pop(next(iter(self._entries)))
                self._m_evictions.inc()
            self._entries[key] = (assoc, self.clock() + ttl, axis, atoms)

    def note_write(self, rows: np.ndarray, cols: np.ndarray) -> None:
        """Evict every cached band the written keys touch (called on the
        write path *before* the mutation is applied/enqueued).  Always
        bumps :attr:`version`, even with nothing cached — in-flight
        scans gate their admission on it."""
        rows = np.asarray(rows, dtype=str)
        cols = np.asarray(cols, dtype=str)
        with self._lock:
            self.version += 1
            self._write_times.append(self.clock())
            if not self._entries:
                return
            doomed = [k for k, (_, _, axis, atoms) in self._entries.items()
                      if self._touches(axis, atoms, rows, cols)]
            for k in doomed:
                del self._entries[k]
            if doomed:
                self._m_evictions.inc(len(doomed))

    @staticmethod
    def _touches(axis: str, atoms: _Atoms, rows: np.ndarray,
                 cols: np.ndarray) -> bool:
        if axis == "any" or atoms.kind == "all":
            return True
        written = rows if axis == "row" else cols
        if written.shape[0] == 0:
            return False
        if atoms.kind == "range":
            lo, hi = atoms.range
            return bool(((written >= lo) & (written <= hi)).any())
        if atoms.keys and bool(
                np.isin(written, np.asarray(atoms.keys, dtype=str)).any()):
            return True
        return any(bool(np.char.startswith(written, p).any())
                   for p in atoms.prefixes)

    def _writes_per_s_locked(self) -> float:
        """Write rate over the trailing ``wps_window`` seconds.  When
        the sample deque is saturated (its maxlen evicted timestamps
        still inside the window), rate over the *retained* span — the
        bounded buffer must not cap the estimate at maxlen/window."""
        now = self.clock()
        cutoff = now - self.wps_window
        while self._write_times and self._write_times[0] < cutoff:
            self._write_times.popleft()
        n = len(self._write_times)
        if n and n == self._write_times.maxlen:
            return n / max(now - self._write_times[0], 1e-9)
        return n / self.wps_window

    @property
    def writes_per_s(self) -> float:
        with self._lock:
            return self._writes_per_s_locked()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return (f"ScanCache(ttl={self.ttl:g}s, entries={len(self)}, "
                f"hits={self.hits}, misses={self.misses})")


class TableStats(dict):
    """Route counters (a plain mapping: ``T.stats["col"]``) that is also
    *callable*: ``T.stats()`` returns one merged observability snapshot —
    route counts plus :class:`ScanCache` hit/miss/admission counters, the
    :class:`~repro_torch.db.writer.WriterPool` queue state, and backend sync/RPC
    counts — so serving layers (the gateway's ``/stats`` endpoint, bench
    assertions) read a single structure instead of poking three objects.

    The snapshot is read-mostly: it takes no barriers, issues no scans,
    and touches only in-process counters (no per-shard RPCs on the net
    backend), so it is safe to poll at stream frequency.
    """

    def __init__(self, table: "DBTable"):
        super().__init__(row=0, col=0, full=0, deg=0,
                         cache_hit=0, cache_miss=0)
        # weakref, not a strong back-pointer: stats lives on the table,
        # so a strong ref here is a table<->stats cycle that keeps every
        # closed backend (and its cells) parked until a full gc pass —
        # a real leak for anything that binds stores in a loop.
        self._table_ref = weakref.ref(table)

    def __call__(self) -> dict:
        t = self._table_ref()
        if t is None:       # table collected mid-call; nothing to report
            return {"routes": {k: v for k, v in self.items()}}
        out = {"routes": {k: v for k, v in self.items()}}
        cache = t._cache or getattr(t.backend, "_scan_cache", None)
        if cache is not None:
            out["cache"] = {"hits": cache.hits, "misses": cache.misses,
                            "batch_hits": cache.batch_hits,
                            "batch_misses": cache.batch_misses,
                            "evictions": cache.evictions,
                            "admission_skips": cache.admission_skips,
                            "entries": len(cache),
                            "writes_per_s": cache.writes_per_s,
                            "full_scan_wps_limit": cache.full_scan_wps_limit}
        else:
            out["cache"] = {"hits": 0, "misses": 0,
                            "batch_hits": 0, "batch_misses": 0,
                            "evictions": 0,
                            "admission_skips": 0, "entries": 0,
                            "writes_per_s": 0.0,
                            "full_scan_wps_limit": float("inf")}
        pool = getattr(t.backend, "_writer_pool", None)
        out["writers"] = pool.stats() if pool is not None else {
            "pending": 0, "queue_depth": 0, "n_written": 0,
            "n_retried": 0, "n_errors": 0, "n_writers": 0,
            "n_taps": 0, "tap_errors": 0}
        insts = getattr(t.backend, "instances", [t.backend])
        out["backend"] = {
            "kind": type(t.backend).__name__,
            "n_instances": len(insts),
            "n_syncs": sum(getattr(i, "n_syncs", 0) for i in insts),
            "n_rpcs": sum(getattr(i, "n_rpcs", 0) for i in insts)}
        return out


# Serializes lazy attachment of shared per-backend state (scan cache,
# writer pool): concurrent pipeline tasks binding the same store must
# never each create one — the loser's buffered writes would be orphaned.
_ATTACH_LOCK = threading.Lock()


def _cache_for(backend, ttl: Optional[float]) -> Optional[ScanCache]:
    """One shared ScanCache per backend; on a MultiInstanceDB the same
    cache is attached to every instance so direct instance writes also
    invalidate.  ``ttl <= 0`` opts this view out (the backend cache, if
    any, still sees invalidations via the store-side hook).  The cache's
    default TTL comes from the first view; each view's own ``cache_ttl``
    still governs the entries *it* inserts (per-entry TTL)."""
    if ttl is None:
        ttl = DEFAULT_SCAN_TTL
    if ttl <= 0:
        return None
    cache = getattr(backend, "_scan_cache", None)
    if cache is None:
        with _ATTACH_LOCK:
            cache = getattr(backend, "_scan_cache", None)
            if cache is None:
                cache = ScanCache(ttl=ttl)
                if isinstance(backend, MultiInstanceDB):
                    for inst in backend.instances:
                        inst._scan_cache = cache
                backend._scan_cache = cache
    return cache


# ---------------------------------------------------------------------------
# DBTable
# ---------------------------------------------------------------------------

class DBTable:
    """An Assoc-compatible view of the edge database.

    Subscripts build deferred expressions (:class:`LazyAssoc`); call
    ``.eval()`` — or any data accessor like ``.triples()`` — to execute.
    ``stats`` counts which physical route served each scan
    (``row``/``col``/``full``/``deg``), which the routing tests assert
    on; *calling* it (``T.stats()``) returns the merged observability
    snapshot (routes + cache + writers + backend) — see
    :class:`TableStats`.
    """

    def __init__(self, backend: Backend, tables: Sequence[str],
                 name: str = "Tedge",
                 degree_limit: Optional[float] = None,
                 cache_ttl: Optional[float] = None):
        unknown = set(tables) - set(_KNOWN_TABLES)
        if unknown:
            raise ValueError(f"unknown table(s) {sorted(unknown)}; "
                             f"expected a subset of {_KNOWN_TABLES}")
        self.backend = backend
        self.tables = tuple(tables)
        self.name = name
        self.degree_limit = degree_limit
        self.cache_ttl = DEFAULT_SCAN_TTL if cache_ttl is None else cache_ttl
        self._cache = _cache_for(backend, self.cache_ttl)
        self.stats = TableStats(self)

    # -- construction-time variants ---------------------------------------
    def with_degree_limit(self, limit: Optional[float]) -> "DBTable":
        t = DBTable(self.backend, self.tables, self.name, limit,
                    cache_ttl=self.cache_ttl)
        t.stats = self.stats        # share counters with the parent view
        return t

    @property
    def _has_transpose(self) -> bool:
        return "TedgeT" in self.tables

    @property
    def _is_degree(self) -> bool:
        return self.tables == ("TedgeDeg",)

    # -- the Assoc surface -------------------------------------------------
    def __getitem__(self, idx) -> LazyAssoc:
        rsel, csel = idx if isinstance(idx, tuple) else (idx, None)
        return LazyAssoc.scan(self, rsel, csel)

    def lazy(self) -> LazyAssoc:
        return LazyAssoc.scan(self, None, None)

    def eval(self) -> Assoc:
        return self.lazy().eval()

    @property
    def T(self) -> LazyAssoc:
        return self.lazy().T

    def logical(self) -> LazyAssoc:
        return self.lazy().logical()

    def sum(self, axis: int) -> LazyAssoc:
        return self.lazy().sum(axis)

    # -- degree table ------------------------------------------------------
    def degree(self, col_key: str) -> float:
        """Point TedgeDeg lookup (the combiner-maintained degree)."""
        self._read_barrier()
        self.stats["deg"] += 1
        return self.backend.degree(col_key)

    def degree_assoc(self, prefix: str = "") -> Assoc:
        """TedgeDeg as an Assoc (keys × 'degree'), optionally restricted
        to a column-key prefix — the power-law analytics input."""
        self._read_barrier()
        self.stats["deg"] += 1
        items = list(self.backend.degree_items(prefix))
        if not items:
            return Assoc()
        keys = np.asarray([k for k, _ in items], dtype=str)
        vals = np.asarray([v for _, v in items], dtype=np.float64)
        return Assoc(keys, "degree,", vals)

    # -- ingest ------------------------------------------------------------
    def put(self, A: Union[Assoc, LazyAssoc], file_id: str = "",
            batch_size: int = 100_000, sync: bool = True) -> int:
        """Batched triple ingest: Tedge + TedgeT + TedgeDeg in one pass.

        Batches model Accumulo's BatchWriter flushes.  On a
        :class:`MultiInstanceDB` each batch is row-hash partitioned across
        instances (independent write paths); passing ``file_id`` instead
        pins the whole put to one instance — the paper's file→instance
        routing used by the pipeline's stage 6.

        With ``sync=False`` batches are *enqueued* to the backend's
        :class:`~repro_torch.db.writer.WriterPool` (created on first use) and
        ``put`` returns immediately; writes become visible no later than
        the next :meth:`flush` — which every scan through the binding
        issues automatically.  Once a pool exists, synchronous puts also
        route through it (then flush) so ordering stays single-streamed
        per instance.
        """
        if isinstance(A, LazyAssoc):
            A = A.eval()
        r, c, v = A.triples()
        v = np.asarray(v).astype(str)
        pool = getattr(self.backend, "_writer_pool", None)
        if not sync and pool is None:
            pool = self.writer()
        cache = self._cache or getattr(self.backend, "_scan_cache", None)
        dest = self.backend
        if file_id and isinstance(dest, MultiInstanceDB):
            dest = dest.route(file_id)
        n = 0
        for lo in range(0, r.shape[0], batch_size):
            hi = lo + batch_size
            rb, cb, vb = r[lo:hi], c[lo:hi], v[lo:hi]
            if pool is not None:
                if cache is not None:   # evict at enqueue, before apply
                    cache.note_write(rb, cb)
                n += pool.submit(rb, cb, vb, pin=file_id or None)
            else:                       # store-side hook invalidates
                n += dest.put_triples(rb, cb, vb)
        if sync and pool is not None:
            pool.flush()
        return n

    # -- async writer control ----------------------------------------------
    def writer(self, **kw) -> WriterPool:
        """The backend's shared :class:`WriterPool`, created on demand
        (``kw`` — e.g. ``maxsize``, ``fault_injector`` — applies only at
        creation).  Creation is serialized: concurrent ingest tasks must
        share one pool, or the loser's buffered writes would vanish."""
        pool = getattr(self.backend, "_writer_pool", None)
        if pool is None:
            with _ATTACH_LOCK:
                pool = getattr(self.backend, "_writer_pool", None)
                if pool is None:
                    pool = WriterPool(self.backend, **kw)
                    self.backend._writer_pool = pool
        return pool

    def add_ingest_tap(self, fn) -> None:
        """Register ``fn(rows, cols, vals)`` to observe every triple
        block as the backend's writers drain it — the streaming-rollup
        hook (:class:`repro_torch.stream.TemporalRollup.ingest` attaches
        here).  Ensures the shared :class:`WriterPool` exists first, so
        *synchronous* puts also route through the pool (and hence the
        tap) from this point on; only direct ``backend.put_triples``
        calls bypass it.  No extra scan is ever issued: the tap sees
        the very arrays the writer just applied."""
        self.writer().add_tap(fn)

    def remove_ingest_tap(self, fn) -> None:
        pool = getattr(self.backend, "_writer_pool", None)
        if pool is not None:
            pool.remove_tap(fn)

    def flush(self) -> None:
        """Barrier: block until queued async writes are applied,
        re-raising any writer error — and, on durable backends, fsync
        the WAL (the commit point; see docs/api.md "Backends").  On a
        synced, empty pool this is cheap (the store's dirty flag gates
        the fsync)."""
        pool = getattr(self.backend, "_writer_pool", None)
        if pool is not None:
            pool.flush()            # drains, then syncs the backend
        else:
            sync = getattr(self.backend, "sync", None)
            if sync is not None:
                sync()              # sync puts still commit at the barrier

    def _read_barrier(self) -> None:
        """Visibility barrier on the read path: waits only for writes
        enqueued *before* this read (the pool's spill-sequence snapshot)
        and skips the durability fsync — so many concurrent reader
        threads stay live during sustained ingest instead of serializing
        behind a write barrier that never empties.  Sync (poolless) puts
        are applied inline and need no wait at all."""
        pool = getattr(self.backend, "_writer_pool", None)
        if pool is not None:
            with _span("writer.drain"):
                pool.drain()

    # -- serving-layer admission hook --------------------------------------
    @property
    def write_rate(self) -> float:
        """Trailing writes/s seen by this backend's scan cache (0.0 when
        caching is disabled) — the admission signal serving layers use."""
        cache = self._cache or getattr(self.backend, "_scan_cache", None)
        return 0.0 if cache is None else cache.writes_per_s

    def admit_full_scan(self) -> bool:
        """Read-mostly admission check for full-table work: False while
        the trailing write rate exceeds the cache's
        ``full_scan_wps_limit`` (the same signal that stops 'any'-band
        cache admission) — a full scan issued now would be stale before
        it finished and its cache entry evicted by the next write.  The
        gateway maps a refusal to HTTP 429 + Retry-After."""
        cache = self._cache or getattr(self.backend, "_scan_cache", None)
        if cache is None:
            return True
        return cache.writes_per_s <= cache.full_scan_wps_limit

    def close(self) -> None:
        """Flush and stop the backend's writer pool (if any); on a
        durable backend with no pool, still fsync — close is a commit
        point either way."""
        pool = getattr(self.backend, "_writer_pool", None)
        if pool is not None:
            try:
                pool.close()            # drains, then syncs the backend
            finally:
                self.backend._writer_pool = None
        else:
            sync = getattr(self.backend, "sync", None)
            if sync is not None:
                sync()

    # -- scan execution (called by the LazyAssoc executor) -----------------
    def _scan(self, rsel, csel) -> Assoc:
        with _span("db.scan", table="+".join(self.tables)) as sp:
            self._read_barrier()        # async writes become visible here
            ratoms = catoms = None
            if not self._is_degree:
                ratoms, catoms = _classify(rsel), _classify(csel)
                if ratoms.kind == "all" and catoms.kind != "all":
                    # the degree guard fires before the cache so a guarded
                    # view refuses super-node bands even when they are hot
                    self._degree_guard(catoms)
            cache = self._cache
            if cache is None:
                return self._scan_route(rsel, csel, ratoms, catoms)
            key = (self.tables, _sel_key(rsel), _sel_key(csel))
            hit = cache.get(key)
            if hit is not None:
                self.stats["cache_hit"] += 1
                sp.tag(cache="hit")
                return hit
            sp.tag(cache="miss")
            v0 = cache.version      # writes after this gate admission
            out = self._scan_route(rsel, csel, ratoms, catoms)
            self.stats["cache_miss"] += 1
            axis, atoms = self._band(rsel, ratoms, catoms)
            cache.put(key, out, axis, atoms, ttl=self.cache_ttl,
                      if_version=v0)
            return out

    def _scan_batch(self, sels) -> list:
        """Serve a batch of subscripts with one union tablet scan per
        physical route (the ``repro_torch.core.expr.eval_batch`` prefetch
        hook): members are grouped row/col/deg, their atoms unioned,
        scanned once, and split per member host-side — each member's
        result is byte-identical to its individual :meth:`_scan` and
        lands its own :class:`ScanCache` entry.

        Route counters tick once per *union* scan (that is what hit the
        tablets); cache hit/miss counters still tick per member, plus
        the batch-path ``batch_hits``/``batch_misses``.

        Returns a list aligned with ``sels``; ``None`` marks members
        this table declines to prefetch (ranges, full scans, positional
        selectors, degree-guard refusals) — they fall back to individual
        :meth:`_scan`, where any error surfaces on the member that
        caused it.
        """
        with _span("db.scan_batch", table="+".join(self.tables),
                   n=len(sels)) as sp:
            return self._scan_batch_impl(sels, sp)

    def _scan_batch_impl(self, sels, sp) -> list:
        self._read_barrier()        # one visibility barrier for the batch
        out: list = [None] * len(sels)
        cache = self._cache
        n_hits = n_misses = 0       # the span's tags
        groups: dict = {"row": [], "col": [], "deg": []}
        for i, (rsel, csel) in enumerate(sels):
            try:
                if self._is_degree:
                    atoms = _classify(rsel)
                    if atoms.kind == "atoms":
                        groups["deg"].append((i, atoms, rsel, csel))
                    continue
                ratoms, catoms = _classify(rsel), _classify(csel)
            except TypeError:
                continue            # positional — raises in its own _scan
            if ratoms.kind == "all" and catoms.kind == "atoms":
                try:
                    self._degree_guard(catoms)
                except AccidentalDenseError:
                    continue        # member re-raises on its own scan
                groups["col"].append((i, catoms, rsel, csel))
            elif ratoms.kind == "atoms":
                groups["row"].append((i, ratoms, rsel, csel))
        for axis, members in groups.items():
            if not members:
                continue
            misses = []
            for m in members:
                i, atoms, rsel, csel = m
                if cache is not None:
                    hit = cache.get(
                        (self.tables, _sel_key(rsel), _sel_key(csel)))
                    if hit is not None:
                        self.stats["cache_hit"] += 1
                        cache._m_batch_hits.inc()
                        n_hits += 1
                        out[i] = hit
                        continue
                    cache._m_batch_misses.inc()
                    n_misses += 1
                misses.append(m)
            if not misses:
                continue
            v0 = cache.version if cache is not None else None
            uatoms = _Atoms(
                "atoms",
                keys=tuple(sorted({k for _, a, _, _ in misses
                                   for k in a.keys})),
                prefixes=tuple(sorted({p for _, a, _, _ in misses
                                       for p in a.prefixes})))
            U = self._scan_union(axis, uatoms)
            for i, atoms, rsel, csel in misses:
                A = self._split_member(U, axis, rsel, csel)
                out[i] = A
                self.stats["cache_miss"] += 1
                if cache is not None:
                    cache.put(
                        (self.tables, _sel_key(rsel), _sel_key(csel)),
                        A, "col" if axis == "deg" else axis, atoms,
                        ttl=self.cache_ttl, if_version=v0)
        if cache is not None:
            sp.tag(hits=n_hits, misses=n_misses)
        return out

    def _scan_union(self, axis: str, uatoms: _Atoms) -> Assoc:
        """One tablet scan covering every batch member on a route."""
        if axis == "deg":
            self.stats["deg"] += 1
            items = [(k, self.backend.degree(k)) for k in uatoms.keys]
            for p in uatoms.prefixes:
                items.extend(self.backend.degree_items(p))
            # a key may match both an exact atom and a prefix atom —
            # dedupe so the split sees each degree once
            dd = {k: v for k, v in items if v}
            if not dd:
                return Assoc()
            return Assoc(np.asarray(list(dd.keys()), dtype=str), "degree,",
                         np.asarray(list(dd.values()), dtype=np.float64))
        if axis == "col":
            self.stats["col"] += 1
            return self._assemble(self._iter_cells(uatoms, transpose=True),
                                  transposed=True)
        self.stats["row"] += 1
        return self._assemble(self._iter_cells(uatoms, transpose=False))

    @staticmethod
    def _split_member(U: Assoc, axis: str, rsel, csel) -> Assoc:
        """A member's slice of the union scan — equal to its own scan
        (the union only adds rows/cols the member's selector rejects)."""
        if U.nnz == 0:
            return Assoc()
        if axis == "col":
            return U[K.All(), csel]
        A = U[rsel, K.All()]
        return A if _is_all(csel) else A[K.All(), csel]

    def _band(self, rsel, ratoms, catoms) -> tuple:
        """(axis, atoms) describing which written keys invalidate this
        scan: degree scans watch column keys (the combiner's inputs),
        row/col scans watch their scanned axis, full scans watch any."""
        if self._is_degree:
            return "col", _classify(rsel)
        if ratoms.kind != "all":
            return "row", ratoms
        if catoms.kind != "all":
            return "col", catoms
        return "any", _Atoms("all")

    def _scan_route(self, rsel, csel, ratoms=None, catoms=None) -> Assoc:
        if self._is_degree:
            return self._scan_degree(rsel, csel)
        if ratoms is None:
            ratoms, catoms = _classify(rsel), _classify(csel)

        if ratoms.kind != "all":
            # row-routed: scan Tedge for the requested rows, refine
            # columns host-side on the (small) result.
            self.stats["row"] += 1
            A = self._assemble(self._iter_cells(ratoms, transpose=False))
            return A if catoms.kind == "all" else A[K.All(), csel]
        if catoms.kind != "all":
            # column-routed: the transpose table turns a column query
            # into a row scan (Accumulo only scans rows efficiently).
            # (degree guard already applied in _scan)
            self.stats["col"] += 1
            A = self._assemble(self._iter_cells(catoms, transpose=True),
                               transposed=True)
            return A
        self.stats["full"] += 1
        return self._assemble(self._iter_cells(_Atoms("all"),
                                               transpose=False))

    def _iter_cells(self, atoms: _Atoms, transpose: bool):
        be = self.backend
        if transpose and not self._has_transpose:
            raise KeyError(
                f"{self.name}: column query needs the transpose table; "
                f"bind with DB('Tedge', 'TedgeT', ...)")
        if atoms.kind == "all":
            yield from be.scan_everything(transpose=transpose)
            return
        if atoms.kind == "range":
            yield from be.scan_key_range(*atoms.range, transpose=transpose)
            return
        if atoms.keys:
            yield from be.scan_keys(list(atoms.keys), transpose=transpose)
        for p in atoms.prefixes:
            yield from be.scan_prefix(p, transpose=transpose)

    @staticmethod
    def _assemble(cells: Iterable[tuple[str, dict]],
                  transposed: bool = False) -> Assoc:
        rows, cols, vals = [], [], []
        for key, cellmap in cells:
            for other, v in cellmap.items():
                rows.append(other if transposed else key)
                cols.append(key if transposed else other)
                vals.append(v)
        if not rows:
            return Assoc()
        return Assoc(np.asarray(rows, dtype=str),
                     np.asarray(cols, dtype=str),
                     np.asarray(vals, dtype=str), agg="min")

    def _scan_degree(self, rsel, csel) -> Assoc:
        atoms = _classify(rsel)
        if atoms.kind == "all":
            A = self.degree_assoc()     # counts the deg route itself
        elif atoms.kind == "range":
            A = self.degree_assoc()[K.KeyRange(*atoms.range), K.All()]
        else:
            self.stats["deg"] += 1
            items = [(k, self.backend.degree(k)) for k in atoms.keys]
            for p in atoms.prefixes:
                items.extend(self.backend.degree_items(p))
            items = [(k, v) for k, v in items if v]
            if not items:
                return Assoc()
            A = Assoc(np.asarray([k for k, _ in items], dtype=str),
                      "degree,",
                      np.asarray([v for _, v in items], dtype=np.float64))
        return A if _is_all(csel) else A[K.All(), csel]

    # -- the anti-"accidental dense" guard ---------------------------------
    def _degree_guard(self, catoms: _Atoms) -> None:
        if self.degree_limit is None or "TedgeDeg" not in self.tables:
            return
        self.stats["deg"] += 1
        probed = [(k, self.backend.degree(k)) for k in catoms.keys]
        for p in catoms.prefixes:
            probed.extend(self.backend.degree_items(p))
        if catoms.kind == "range":
            lo, hi = catoms.range
            probed.extend((k, d) for k, d in self.backend.degree_items()
                          if lo <= k <= hi)
        offenders = [(k, d) for k, d in probed if d > self.degree_limit]
        if offenders:
            offenders.sort(key=lambda kv: -kv[1])
            raise AccidentalDenseError(offenders, self.degree_limit)

    # -- misc --------------------------------------------------------------
    @property
    def n_entries(self) -> int:
        return self.backend.n_entries

    def __repr__(self):
        kind = "+".join(self.tables)
        return (f"DBTable({kind} on {type(self.backend).__name__}, "
                f"degree_limit={self.degree_limit})")


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

def DB(*tables: str, backend: Union[Backend, str, None] = None,
       n_instances: int = 1, tablets_per_instance: int = 4,
       degree_limit: Optional[float] = None,
       cache_ttl: Optional[float] = None,
       path: Optional[str] = None, **backend_options) -> DBTable:
    """Bind database tables into one associative-array view (paper §III).

    ``DB('Tedge', 'TedgeT')`` enables row *and* column subscripts;
    adding ``'TedgeDeg'`` wires in the degree guard and
    :meth:`DBTable.degree_assoc`; ``DB('TedgeDeg')`` alone views just the
    degree table.

    ``backend`` selects the storage engine: an existing store object, or
    a registered name — ``"memory"`` (the default: a fresh
    :class:`MultiInstanceDB`, or single :class:`EdgeStore` when
    ``n_instances == 1``), ``"lsm"`` (the persistent
    :class:`~repro_torch.db.lsmstore.LSMStore`, which requires ``path=``
    and shards instances across ``path/db*`` subdirectories when
    ``n_instances > 1``), or ``"net"`` (networked shard servers —
    :class:`~repro_torch.db.netstore.NetMultiInstanceDB`; pass
    ``addresses=["host:port", ...]`` for running servers, or let it
    auto-start ``n_instances`` local shards).  Extra ``backend_options``
    (e.g.
    ``memtable_limit``, ``coordination_cost_s``) pass to the engine
    factory; see ``repro_torch.db.registry``.  ``cache_ttl`` tunes the scan
    cache (default ``DEFAULT_SCAN_TTL``; ``0`` opts this view out of
    cached reads).
    """
    if not tables:
        tables = _KNOWN_TABLES
    if backend is None or isinstance(backend, str):
        backend = make_backend(
            backend if isinstance(backend, str) else "memory",
            n_instances=n_instances,
            tablets_per_instance=tablets_per_instance,
            path=path, **backend_options)
    return DBTable(backend, tables, name=tables[0],
                   degree_limit=degree_limit, cache_ttl=cache_ttl)


def bind(db, degree_limit: Optional[float] = None,
         cache_ttl: Optional[float] = None) -> DBTable:
    """Wrap an existing store (or pass a DBTable through) — the adapter
    legacy call sites use to reach the new query surface."""
    if isinstance(db, DBTable):
        return db
    return DBTable(db, _KNOWN_TABLES, degree_limit=degree_limit,
                   cache_ttl=cache_ttl)


def put(T: DBTable, A: Union[Assoc, LazyAssoc], file_id: str = "",
        batch_size: int = 100_000, sync: bool = True) -> int:
    """Module-level D4M idiom: ``put(T, putval(E, '1,'))``."""
    return T.put(A, file_id=file_id, batch_size=batch_size, sync=sync)
