"""Hierarchical time-bucket rollups over the async-ingest triple stream.

:class:`TemporalRollup` consumes the exact triple blocks the
:class:`~repro_torch.db.writer.WriterPool` coalesces — registered as an
ingest tap (``DBTable.add_ingest_tap``) it observes every block *as it drains*,
so the streaming aggregates ride the write path with no extra table
scan.  Triples are attributed to **hierarchical time buckets**
(packet → second → minute → hour); each level accumulates its own
Assoc-compatible aggregate (cell/packet counts, unique src/dst support,
per-key degree sketches), so the conservation law *child buckets sum
exactly to their parent* is a real cross-check of the attribution, not
an artifact of derivation.

On close, each bucket is summarized — including a per-level
**scaling-relation** fit (rank-size power law of the destination-degree
distribution via the existing :func:`~repro_torch.analytics.powerlaw.
fit_rank_size`), the paper's observation that sub-sampled traffic
windows obey the same heavy-tailed background as the whole trace.

Timestamps come from the incidence schema itself: every packet row
carries exactly one ``frame.time|<epoch>`` column (``val2col``
explosion).  A block may arrive *before* the block holding its rows'
time triples (``put(batch_size=...)`` slicing can split a packet across
blocks), so unattributed triples park in a bounded pending map keyed by
row and drain the moment the row's timestamp is learned.

Thread-safety: ``ingest`` is called from WriterPool writer threads (one
per pool instance) and only parks block references under the rollup
lock — O(1), no parsing or copying on the write path.  Readers
(``summaries``, ``totals``, ``slice``, ``close_due``) drain the parked
backlog under the same lock before reading, so they always see every
block ingested before the call.  A backlog past ``max_backlog_blocks``
drains inline on the writer thread: a slow consumer still
backpressures ingest, just amortized — same contract as a slow
accumulator combiner.
"""
from __future__ import annotations

import threading
import weakref
from collections import Counter, OrderedDict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

from ..analytics.powerlaw import fit_rank_size
from ..analytics.serialize import JsonReportMixin
from ..core.assoc import Assoc
from ..core.sparse import to_device
from ..obs.metrics import REGISTRY as _REGISTRY, obj_label as _obj_label

_M_LATE = _REGISTRY.counter(
    "repro_stream_late_total",
    "Triples attributed to already-closed buckets", labels=("rollup",))
_M_BACKLOG = _REGISTRY.gauge(
    "repro_stream_backlog_blocks",
    "Ingest-tap blocks parked awaiting a reader drain", labels=("rollup",))

#: level name → bucket width in seconds (hierarchy must nest exactly:
#: every width divides the next one up, or conservation is vacuous).
LEVEL_SECONDS: "OrderedDict[str, float]" = OrderedDict(
    [("second", 1.0), ("minute", 60.0), ("hour", 3600.0)])


class WindowSummary(NamedTuple):
    """One closed bucket, flattened to the JSON-report shape the gateway
    ships from ``/v1/windows`` (same serialize path as C2Report)."""
    level: str
    start: float               # bucket start (epoch seconds, aligned)
    width: float               # bucket width in seconds
    n_cells: int               # triples attributed (= table cells)
    n_packets: int             # distinct packets (one frame.time each)
    n_src: int                 # unique ip.src keys
    n_dst: int                 # unique ip.dst keys
    max_dst_deg: float         # busiest destination's packet count
    top_dst: str
    top_dst_share: float       # max_dst_deg / total dst packet mass
    alpha: float               # rank-size exponent of dst degrees (NaN
    r2: float                  # when too few keys to fit), and fit R²
    truncated: bool            # slice retention clipped (counts exact)

    to_dict = JsonReportMixin.to_dict
    to_json = JsonReportMixin.to_json
    from_dict = classmethod(JsonReportMixin.from_dict.__func__)


class _Bucket:
    """One live bucket at one level: exact counters plus (base level
    only) the retained triples backing ``slice()``.

    Retention is by *reference*, not copy: ``chunks`` holds
    ``(r, c, v, idx)`` where ``idx`` is an integer index array into the
    ingested block's arrays (``None`` = the whole block), and
    ``deg_pending`` holds ``(c, idx)`` pairs the degree fold has not
    consumed yet.  The write path therefore never gathers or
    prefix-matches the unicode arrays — that materialization happens on
    the read side (``TemporalRollup._fold_deg`` / ``slice``), keeping
    the expensive string ops off the WriterPool drain loop, which
    carries the tap's <10% ingest overhead budget.  Buckets sharing a
    block share its arrays, so a block stays alive until every bucket
    referencing it is evicted."""
    __slots__ = ("start", "n_cells", "n_packets", "deg", "deg_pending",
                 "chunks", "slice_cells", "truncated", "closed")

    def __init__(self, start: float):
        self.start = start
        self.n_cells = 0
        self.n_packets = 0
        self.deg: Counter = Counter()    # full col key → packet count
        self.deg_pending: list = []      # [(cols, idx)] not yet folded
        self.chunks: list = []           # [(r, c, v, idx)] — base only
        self.slice_cells = 0
        self.truncated = False
        self.closed = False


class _DegreeView:
    """Duck-typed ``degree_assoc(prefix)`` view of one bucket's degree
    sketch — makes a rollup bucket a drop-in for
    :func:`~repro_torch.analytics.powerlaw.fit_degree_table`, which normally
    reads a DBTable's combiner-maintained TedgeDeg."""

    def __init__(self, bucket: _Bucket):
        self._deg = bucket.deg

    def degree_assoc(self, prefix: str = "") -> Assoc:
        items = sorted((k, v) for k, v in self._deg.items()
                       if k.startswith(prefix))
        if not items:
            return Assoc()
        keys = np.asarray([k for k, _ in items], dtype=str)
        vals = np.asarray([float(v) for _, v in items])
        return Assoc(keys, np.repeat(np.asarray(["degree"]), len(items)),
                     vals)


def _pow2_pad(d: np.ndarray) -> np.ndarray:
    """Zero-pad a degree vector to the next power-of-two length: zeros
    carry zero weight in ``fit_rank_size``, so alpha is unchanged, and
    the fit reduces the same vector as the JAX package's (padded there so
    its jit cache sees O(log n) shapes instead of one per window)."""
    n = max(int(d.shape[0]), 1)
    target = 1 << (n - 1).bit_length()
    return np.pad(d, (0, target - d.shape[0]))


class TemporalRollup:
    """Streaming hierarchical time-bucket aggregation (see module doc).

    Parameters
    ----------
    levels : ordered level names from :data:`LEVEL_SECONDS` (base first).
    time_field : the schema field carrying the packet timestamp; matched
        as ``f"{time_field}{sep}"`` exactly, so ``frame.time_relative|``
        columns (same field-name prefix) are *not* mistaken for it.
    lateness_s : watermark lag — a bucket closes only once the max
        observed timestamp clears its end by this much.
    track_prefixes : column bands kept in the per-bucket degree sketch.
    slice_cells_per_bucket : base-level triple retention cap backing
        ``slice()``; beyond it the bucket is marked truncated (counter
        aggregates stay exact).
    max_row_ts / max_pending_rows : bounds on the row→timestamp map and
        the park-until-timestamp pending map (LRU/FIFO evicted; evicted
        pending triples count as unattributed, never silently vanish).
    max_backlog_blocks : ingest-deferral bound — blocks the write path
        may park unprocessed before it must drain them inline (readers
        drain on every call, so this only binds with no reader polling).
    """

    def __init__(self, levels: Iterable[str] = ("second", "minute", "hour"),
                 sep: str = "|", time_field: str = "frame.time",
                 lateness_s: float = 2.0,
                 track_prefixes: Iterable[str] = ("ip.src", "ip.dst",
                                                  "tcp.dstport"),
                 slice_cells_per_bucket: int = 2_000_000,
                 max_row_ts: int = 1_000_000,
                 max_pending_rows: int = 100_000,
                 max_summaries: int = 4096,
                 max_buckets: int = 8192,
                 fit_min_keys: int = 4,
                 max_backlog_blocks: int = 64):
        widths = []
        for lv in levels:
            if lv not in LEVEL_SECONDS:
                raise ValueError(f"unknown level {lv!r} "
                                 f"(have {list(LEVEL_SECONDS)})")
            widths.append((lv, LEVEL_SECONDS[lv]))
        widths.sort(key=lambda p: p[1])
        for (_, wa), (_, wb) in zip(widths, widths[1:]):
            if wb % wa:
                raise ValueError("levels must nest exactly")
        self.levels: Tuple[Tuple[str, float], ...] = tuple(widths)
        self.base_level = widths[0][0]
        self._base_width = widths[0][1]
        self.sep = sep
        self.time_field = time_field
        self._time_prefix = f"{time_field}{sep}"
        self.lateness_s = float(lateness_s)
        self.track_prefixes = tuple(f"{p}{sep}" for p in track_prefixes)
        self.slice_cells_per_bucket = int(slice_cells_per_bucket)
        self.max_row_ts = int(max_row_ts)
        self.max_pending_rows = int(max_pending_rows)
        self.max_summaries = int(max_summaries)
        self.max_buckets = int(max_buckets)
        self.fit_min_keys = int(fit_min_keys)
        self.max_backlog_blocks = int(max_backlog_blocks)

        self._lock = threading.RLock()
        # write-path deferral: ingest() parks block references here and
        # returns; any read drains it (see _drain_locked).  Bounded —
        # the cap forces an inline drain, so a slow consumer still
        # backpressures ingest, just amortized over the backlog.
        self._backlog: list = []
        self._buckets: Dict[str, Dict[float, _Bucket]] = \
            {lv: {} for lv, _ in self.levels}
        self._summaries: Dict[str, "OrderedDict[float, WindowSummary]"] = \
            {lv: OrderedDict() for lv, _ in self.levels}
        self._row_ts: "OrderedDict[str, float]" = OrderedDict()
        self._pending: Dict[str, list] = {}
        self._n_pending = 0
        # eviction remainders: totals() stays exact for counts even after
        # old closed buckets (and their degree sketches/chunks) age out
        self._evicted: Dict[str, Dict[str, int]] = \
            {lv: {"n_cells": 0, "n_packets": 0, "n_buckets": 0}
             for lv, _ in self.levels}

        # counters (exactness bookkeeping — see stats())
        self.n_blocks = 0
        self.n_ingested = 0          # triples seen
        self.n_attributed = 0        # triples placed in buckets (×1/level)
        self.n_unattributed = 0      # evicted pending: timestamp never seen
        self.max_ts = -np.inf
        self.metrics_label = _obj_label("rollup")
        # attributed-after-bucket-close counter, registry-backed
        self._m_late = _M_LATE.labels(rollup=self.metrics_label)
        self._m_backlog = _M_BACKLOG.labels(rollup=self.metrics_label)
        ref = weakref.ref(self)
        self._m_backlog.set_function(lambda: len(ref()._backlog))

    @property
    def n_late(self) -> int:
        """Triples attributed after their bucket closed (registry-backed
        compat shape)."""
        return self._m_late.value

    # ---------------------------------------------------------- ingest

    def ingest(self, r, c, v) -> None:
        """Tap entry point — one coalesced triple block as WriterPool
        drains it.  Called from writer threads; O(1): the block's array
        references park in a bounded backlog and all processing happens
        on the *reader's* thread at the next ``totals``/``summaries``/
        ``slice``/``close_due``/``stats`` call (or inline here once the
        backlog hits ``max_backlog_blocks`` — amortized backpressure).
        This is what keeps the tap inside its <10% ingest-overhead
        budget: the write path never parses, matches, or copies a
        string."""
        with self._lock:
            self._backlog.append((r, c, v))
            if len(self._backlog) >= self.max_backlog_blocks:
                self._drain_locked()

    def _drain_locked(self) -> None:
        """Process every parked block in arrival order (lock held)."""
        backlog, self._backlog = self._backlog, []
        for r, c, v in backlog:
            r, c = (a if isinstance(a, np.ndarray) and a.dtype.kind == "U"
                    else np.asarray(a, dtype=str) for a in (r, c))
            v = np.asarray(v)  # only stored (slice chunks), never parsed
            if r.shape[0]:
                self._ingest_locked(r, c, v)

    def _ingest_locked(self, r, c, v) -> None:
        self.n_blocks += 1
        self.n_ingested += int(r.shape[0])

        # 1. learn row → timestamp from this block's time triples; the
        # epoch parse runs through numpy's C float parser, with a
        # per-cell fallback only if some cell is malformed
        tp = self._time_prefix
        k = len(tp)
        is_time = np.char.startswith(c, tp)
        newly: list = []
        if is_time.any():
            t_rows = r[is_time].tolist()
            t_strs = [s[k:] for s in c[is_time].tolist()]
            try:
                t_vals = np.asarray(t_strs, dtype=np.float64).tolist()
            except ValueError:       # drop malformed cells, keep the rest
                keep_rows, t_vals = [], []
                for row, s in zip(t_rows, t_strs):
                    try:
                        t_vals.append(float(s))
                        keep_rows.append(row)
                    except ValueError:
                        continue
                t_rows = keep_rows
            if t_vals:
                if self._pending:
                    newly = [row for row in t_rows
                             if row in self._pending]
                self._row_ts.update(zip(t_rows, t_vals))
                m = max(t_vals)
                if m > self.max_ts:
                    self.max_ts = m
                while len(self._row_ts) > self.max_row_ts:
                    self._row_ts.popitem(last=False)

        # 2. resolve each triple's timestamp through the row map.  A
        # packet's cells sit adjacent in its put's sorted triples, so
        # grouping identical *runs* gets ~one lookup per packet without
        # np.unique's argsort; a row split across non-adjacent runs just
        # pays a second dict hit.
        if r.shape[0] > 1:
            bounds = np.r_[0, 1 + np.nonzero(r[1:] != r[:-1])[0]]
        else:
            bounds = np.zeros(1, dtype=np.intp)
        runs = np.diff(np.r_[bounds, r.shape[0]])
        ts_u = np.fromiter(
            (self._row_ts.get(k, np.nan) for k in r[bounds].tolist()),
            dtype=np.float64, count=bounds.shape[0])
        ts = np.repeat(ts_u, runs)
        known = ~np.isnan(ts)

        # 3. park triples whose row timestamp hasn't arrived yet
        if not known.all():
            for row, col, val in zip(r[~known], c[~known], v[~known]):
                self._pending.setdefault(row, []).append((col, val))
                self._n_pending += 1
            while (len(self._pending) > self.max_pending_rows
                   and self._pending):
                oldest = next(iter(self._pending))
                lost = self._pending.pop(oldest)
                self._n_pending -= len(lost)
                self.n_unattributed += len(lost)

        if known.all():
            self._attribute(r, c, v, ts, is_time)
        elif known.any():
            self._attribute(r[known], c[known], v[known], ts[known],
                            is_time[known])

        # 4. drain pending rows resolved by this block's time triples
        for row in newly:
            parked = self._pending.pop(row, None)
            if not parked:
                continue
            self._n_pending -= len(parked)
            pc = np.asarray([p[0] for p in parked], dtype=str)
            pv = np.asarray([p[1] for p in parked])
            pr = np.repeat(np.asarray([row], dtype=str), pc.shape[0])
            pts = np.full(pc.shape[0], self._row_ts[row])
            self._attribute(pr, pc, pv, pts,
                            np.char.startswith(pc, tp))

    def _attribute(self, r, c, v, ts, is_time) -> None:
        """Place timestamped triples into every level's bucket.  Each
        level accumulates independently from the same triples — that is
        what makes child-sums-to-parent a genuine invariant check.

        The write-path budget (``bench_stream``: the attached tap within
        10% of untapped ingest) rules out re-grouping per level: cells
        are grouped once at base granularity, and because coarser widths
        nest exactly (validated in ``__init__``), every base group lands
        whole in one parent bucket — the same scalar counts and one
        shared column-array reference update all levels.  Degree
        counting (prefix match + unique) is deferred to
        :meth:`_fold_deg` at close/read time."""
        self.n_attributed += int(r.shape[0])
        bw = self._base_width
        starts = np.floor(ts / bw) * bw
        # Zero string copies on the write path: a bucket stores *index
        # arrays* into the block's (r, c, v) — materialized only by the
        # read side (``slice`` / ``_fold_deg``).  Grouping runs on the
        # integer bucket ids (unique + bincount + argsort), never by
        # gathering the unicode arrays, whose memcpy dominates the tap
        # cost on coalesced blocks.  ``idx is None`` means the whole
        # block (the common one-bucket-per-put case: no sort at all).
        if starts.shape[0] > 1 and starts.min() != starts.max():
            uniq, inv = np.unique(starts, return_inverse=True)
            counts = np.bincount(inv)
            n_pks = np.bincount(inv[is_time], minlength=uniq.shape[0])
            order = np.argsort(inv, kind="stable")
            bnd = np.r_[0, np.cumsum(counts)]
            groups = [(float(uniq[i]), int(counts[i]), int(n_pks[i]),
                       order[bnd[i]:bnd[i + 1]])
                      for i in range(uniq.shape[0])]
        else:
            groups = [(float(starts[0]), int(starts.shape[0]),
                       int(np.count_nonzero(is_time)), None)]
        for s, n, n_pk, idx in groups:
            for level, width in self.levels:
                bs = float(np.floor(s / width) * width)
                buckets = self._buckets[level]
                b = buckets.get(bs)
                if b is None:
                    b = buckets[bs] = _Bucket(bs)
                if b.closed:
                    self._m_late.inc(n)
                b.n_cells += n
                b.n_packets += n_pk
                b.deg_pending.append((c, idx))
                if level == self.base_level:
                    if b.slice_cells + n <= self.slice_cells_per_bucket:
                        b.chunks.append((r, c, v, idx))
                        b.slice_cells += n
                    else:
                        b.truncated = True

    def _fold_deg(self, b: _Bucket) -> None:
        """Materialize a bucket's deferred degree increments (lock
        held).  Idempotent: pending arrays are consumed."""
        if not b.deg_pending:
            return
        parts = [cols if idx is None else cols[idx]
                 for cols, idx in b.deg_pending]
        b.deg_pending = []
        cols = parts[0] if len(parts) == 1 else np.concatenate(parts)
        tracked = np.zeros(cols.shape[0], dtype=bool)
        for pfx in self.track_prefixes:
            tracked |= np.char.startswith(cols, pfx)
        if tracked.any():
            ck, cn = np.unique(cols[tracked], return_counts=True)
            b.deg.update(dict(zip(ck.tolist(), cn.tolist())))

    # ----------------------------------------------------------- close

    @property
    def watermark(self) -> float:
        """Largest timestamp safe to close below: max seen − lateness."""
        with self._lock:
            self._drain_locked()
            return self.max_ts - self.lateness_s

    def close_due(self, now: Optional[float] = None,
                  force: bool = False) -> List[WindowSummary]:
        """Close every bucket whose end has passed the watermark (or all
        open buckets, with ``force`` — end-of-stream flush).  Returns the
        fresh summaries ordered by (width, start): base level first, so
        a consumer sees seconds before the minute containing them."""
        out: List[WindowSummary] = []
        with self._lock:
            self._drain_locked()
            wm = (self.max_ts - self.lateness_s if now is None
                  else now - self.lateness_s)
            for level, width in self.levels:
                for s in sorted(self._buckets[level]):
                    b = self._buckets[level][s]
                    if b.closed:
                        continue
                    if not force and s + width > wm:
                        break
                    b.closed = True
                    summ = self._summarize(level, width, b)
                    store = self._summaries[level]
                    store[s] = summ
                    while len(store) > self.max_summaries:
                        store.popitem(last=False)
                    out.append(summ)
                self._evict_locked(level)
        out.sort(key=lambda w: (w.width, w.start))
        return out

    def _evict_locked(self, level: str) -> None:
        """Age out the oldest *closed* buckets past ``max_buckets`` —
        base-level buckets retain triples, so retention must be bounded.
        Their counts roll into the eviction remainder so ``totals()``
        stays exact; their degree sketches and slices are gone."""
        buckets = self._buckets[level]
        if len(buckets) <= self.max_buckets:
            return
        ev = self._evicted[level]
        for s in sorted(buckets):
            if len(buckets) <= self.max_buckets:
                break
            b = buckets[s]
            if not b.closed:
                break                   # never evict ahead of the watermark
            ev["n_cells"] += b.n_cells
            ev["n_packets"] += b.n_packets
            ev["n_buckets"] += 1
            del buckets[s]

    def _summarize(self, level: str, width: float,
                   b: _Bucket) -> WindowSummary:
        self._fold_deg(b)
        src_pfx = f"ip.src{self.sep}"
        dst_pfx = f"ip.dst{self.sep}"
        n_src = n_dst = 0
        top_dst, max_deg, dst_mass = "", 0.0, 0.0
        dst_degs = []
        for k, n in b.deg.items():
            if k.startswith(src_pfx):
                n_src += 1
            elif k.startswith(dst_pfx):
                n_dst += 1
                dst_degs.append(float(n))
                dst_mass += n
                if n > max_deg:
                    max_deg, top_dst = float(n), k[len(dst_pfx):]
        alpha = r2 = float("nan")
        if len(dst_degs) >= self.fit_min_keys:
            fit = fit_rank_size(to_device(_pow2_pad(
                np.asarray(dst_degs, np.float32))))
            alpha, r2 = float(fit.alpha), float(fit.r2)
        return WindowSummary(
            level=level, start=b.start, width=width,
            n_cells=b.n_cells, n_packets=b.n_packets,
            n_src=n_src, n_dst=n_dst, max_dst_deg=max_deg,
            top_dst=top_dst,
            top_dst_share=max_deg / dst_mass if dst_mass else 0.0,
            alpha=alpha, r2=r2, truncated=b.truncated)

    # ---------------------------------------------------------- access

    def summaries(self, level: str = "second", limit: int = 100,
                  since: Optional[float] = None) -> List[WindowSummary]:
        """Closed-window summaries for one level, oldest first."""
        with self._lock:
            self._drain_locked()
            items = list(self._summaries[level].values())
        if since is not None:
            items = [s for s in items if s.start >= since]
        return items[-limit:]

    def degree_view(self, level: str, start: float) -> _DegreeView:
        """A ``fit_degree_table``-compatible view of one bucket's degree
        sketch (``fit_degree_table(rollup.degree_view(...), "ip.dst|")``)."""
        with self._lock:
            self._drain_locked()
            b = self._buckets[level][start]
            self._fold_deg(b)
            return _DegreeView(b)

    def totals(self, level: str) -> dict:
        """Exact per-level totals over *all* buckets (open + closed) —
        the quantity the conservation and batch-recount checks compare."""
        with self._lock:
            self._drain_locked()
            ev = self._evicted[level]
            n_cells, n_packets = ev["n_cells"], ev["n_packets"]
            deg: Counter = Counter()
            for b in self._buckets[level].values():
                n_cells += b.n_cells
                n_packets += b.n_packets
                self._fold_deg(b)
                deg.update(b.deg)
            return {"n_cells": n_cells, "n_packets": n_packets,
                    "deg": deg, "n_evicted_buckets": ev["n_buckets"]}

    def slice(self, start: float, stop: float) -> Assoc:
        """The retained incidence sub-Assoc for ``[start, stop)`` —
        base-level chunks reassembled, bucket-aligned.  This is what the
        streaming detectors hand to ``c2_scores`` / ``scan_hits`` /
        ``pagerank_table``: an in-memory window, no table rescan."""
        width = dict(self.levels)[self.base_level]
        with self._lock:
            self._drain_locked()
            chunks = []
            for s, b in self._buckets[self.base_level].items():
                if s + width <= start or s >= stop:
                    continue
                chunks.extend(b.chunks)
        if not chunks:
            return Assoc()
        r = np.concatenate([ch[0] if ch[3] is None else ch[0][ch[3]]
                            for ch in chunks])
        c = np.concatenate([ch[1] if ch[3] is None else ch[1][ch[3]]
                            for ch in chunks])
        v = np.concatenate([ch[2] if ch[3] is None else ch[2][ch[3]]
                            for ch in chunks])
        return Assoc(r, c, v, agg="min")

    def stats(self) -> dict:
        with self._lock:
            self._drain_locked()
            open_b = {lv: sum(not b.closed for b in bs.values())
                      for lv, bs in self._buckets.items()}
            closed = {lv: len(s) for lv, s in self._summaries.items()}
            return {
                "n_blocks": self.n_blocks,
                "n_ingested": self.n_ingested,
                "n_attributed": self.n_attributed,
                "n_unattributed": self.n_unattributed,
                "n_late": self.n_late,
                "n_pending": self._n_pending,
                "n_row_ts": len(self._row_ts),
                "max_ts": None if self.max_ts == -np.inf
                else float(self.max_ts),
                "open_buckets": open_b,
                "closed_windows": closed,
            }
