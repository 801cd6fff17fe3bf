"""Online detectors over closed rollup windows.

Four detector families run as windows close, all reusing the batch
analytics cores rather than re-implementing them:

* **SPC** — rolling mean/σ statistical process control per summary
  metric (packet rate, cell rate, unique src/dst) with the Western
  Electric run rules.  The baseline is a trailing window, so the
  diurnal load curve is absorbed as slow drift; only the sharper rules
  (1: beyond 3σ, 2: two-of-three beyond 2σ) raise alerts by default —
  rules 3/4 trip on sustained ramps and stay advisory.
* **C2 beaconing** — :func:`~repro_torch.analytics.anomaly.c2_scores` (the
  ``detect_c2`` scoring core) over each closed *minute*'s retained
  slice; thresholded on fused score and fan-in.
* **scan / DDoS bursts** — :func:`~repro_torch.analytics.anomaly.scan_hits`
  over each closed *second*'s slice, plus a rate-spike × destination-
  concentration gate for DDoS (packet-rate z-score from the SPC state
  joined with the window's ``top_dst_share``).
* **root-cause localization** (MicroRCA-style) — personalized PageRank
  over the anomalous sub-window's subgraph, *reversed* so rank mass
  flows from the victim back through the hosts feeding it traffic;
  rides the existing
  :func:`~repro_torch.analytics.distributed.pagerank_table` on the
  device.

:class:`StreamAnalytics` composes a rollup with a detector bank and
attaches to a live :class:`~repro_torch.db.binding.DBTable` via the ingest
tap — the end-to-end streaming pipeline in one object.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np

from ..analytics.anomaly import c2_scores, scan_hits
from ..analytics.distributed import pagerank_table
from ..analytics.serialize import JsonReportMixin
from .windows import TemporalRollup, WindowSummary


class AlertReport(NamedTuple):
    """One alert, JSON-serializable (same mixin path as C2Report)."""
    kind: str                  # 'spc' | 'c2' | 'scan' | 'ddos'
    level: str                 # rollup level the window came from
    window_start: float
    window_stop: float
    metric: str                # SPC metric, or '' for graph detectors
    rule: int                  # Western Electric rule #, 0 otherwise
    score: float               # z-score / fused C2 score / fan-out
    hosts: np.ndarray          # suspected attacker hosts (may be empty)
    victim: str                # victim host ('' when n/a)
    detail: dict

    to_dict = JsonReportMixin.to_dict
    to_json = JsonReportMixin.to_json
    from_dict = classmethod(JsonReportMixin.from_dict.__func__)


class RootCauseReport(NamedTuple):
    """Root-cause ranking for one anomalous window: hosts ordered by
    reversed personalized-PageRank mass flowing back from the seeds."""
    hosts: np.ndarray
    ranks: np.ndarray
    seeds: np.ndarray
    window_start: float
    window_stop: float

    to_dict = JsonReportMixin.to_dict
    to_json = JsonReportMixin.to_json
    from_dict = classmethod(JsonReportMixin.from_dict.__func__)


class WesternElectric:
    """Rolling mean/σ SPC chart with the four Western Electric rules.

    ``update(x)`` returns ``(rule, z)``: the lowest-numbered rule that
    fired (0 if none) and the z-score of ``x`` against the *trailing*
    baseline (the sample enters the baseline only after being scored, so
    a step change is judged against the pre-step regime).  ``sigma_floor_
    frac`` floors σ at a fraction of |mean| — Poisson shot noise on a
    busy link is a few percent of the mean, and without the floor a
    quiet metric alarms on counting noise.
    """

    def __init__(self, baseline: int = 60, min_baseline: int = 10,
                 sigma_floor_frac: float = 0.15):
        self.baseline = int(baseline)
        self.min_baseline = int(min_baseline)
        self.sigma_floor_frac = float(sigma_floor_frac)
        self._hist: deque = deque(maxlen=self.baseline)
        self._z: deque = deque(maxlen=8)

    def update(self, x: float) -> tuple:
        rule, z = 0, 0.0
        if len(self._hist) >= self.min_baseline:
            h = np.asarray(self._hist, np.float64)
            mean = float(h.mean())
            sigma = max(float(h.std()),
                        self.sigma_floor_frac * abs(mean), 1e-9)
            z = (float(x) - mean) / sigma
            self._z.append(z)
            rule = self._check()
        self._hist.append(float(x))
        return rule, z

    def _check(self) -> int:
        zs = list(self._z)
        if abs(zs[-1]) > 3.0:
            return 1
        for side in (1.0, -1.0):
            s = [z * side for z in zs]
            if len(s) >= 3 and sum(z > 2.0 for z in s[-3:]) >= 2:
                return 2
            if len(s) >= 5 and sum(z > 1.0 for z in s[-5:]) >= 4:
                return 3
            if len(s) >= 8 and all(z > 0.0 for z in s[-8:]):
                return 4
        return 0


def root_cause(source, start: float, stop: float,
               seeds: Sequence[str], top_k: int = 5,
               num_iters: int = 30, damping: float = 0.3,
               sep: str = "|") -> RootCauseReport:
    """MicroRCA-style localization: personalized PageRank over the
    anomalous sub-window's subgraph, reversed so mass flows from the
    seed victim(s) back to the traffic sources feeding them.  ``source``
    is a :class:`TemporalRollup` (its retained ``slice`` is used) or any
    Queryable incidence the selection grammar accepts.  Seeds are
    excluded from the returned ranking.

    ``damping`` defaults well below the web-surfing 0.85: attack sources
    have near-zero in-degree, so at high damping their rank drains to
    whichever background host sent them a stray packet — restart
    dominance keeps the mass within a hop or two of the seeds, which is
    exactly the localization radius MicroRCA wants."""
    E = source.slice(start, stop) if hasattr(source, "slice") else source
    seeds = [str(s) for s in seeds]
    keys, ranks = pagerank_table(
        E, sep=sep, num_iters=num_iters, reverse=True, damping=damping,
        personalize={s: 1.0 for s in seeds})
    ranks = ranks.cpu().numpy().astype(np.float64)
    keep = ~np.isin(keys, np.asarray(seeds, dtype=str)) \
        if keys.shape[0] else np.zeros(0, bool)
    keys, ranks = keys[keep], ranks[keep]
    order = np.argsort(ranks)[::-1][:top_k]
    return RootCauseReport(np.asarray(keys[order], dtype=str),
                           ranks[order],
                           np.asarray(seeds, dtype=str), start, stop)


class DetectorBank:
    """Runs the online detectors over whatever windows the rollup
    closes.  ``process()`` pulls newly closed windows (optionally
    forcing an end-of-stream flush) and returns fresh alerts; alerts
    are also kept in a bounded history and fanned out to ``on_alert``
    callbacks (the gateway's SSE publisher rides those)."""

    def __init__(self, rollup: TemporalRollup,
                 spc_metrics: Iterable[str] = ("n_packets", "n_cells",
                                               "n_src", "n_dst"),
                 spc_level: str = "second",
                 alert_rules: Iterable[int] = (1, 2),
                 spc_kw: Optional[dict] = None,
                 beacon_level: str = "minute",
                 beacon_min_score: float = 0.5,
                 beacon_min_fanin: float = 3.0,
                 scan_level: str = "second",
                 scan_min_fanout: int = 24,
                 ddos_min_z: float = 3.0,
                 ddos_min_share: float = 0.55,
                 history: int = 1024):
        self.rollup = rollup
        self.spc_metrics = tuple(spc_metrics)
        self.spc_level = spc_level
        self.alert_rules = frozenset(alert_rules)
        self.beacon_level = beacon_level
        self.beacon_min_score = float(beacon_min_score)
        self.beacon_min_fanin = float(beacon_min_fanin)
        self.scan_level = scan_level
        self.scan_min_fanout = int(scan_min_fanout)
        self.ddos_min_z = float(ddos_min_z)
        self.ddos_min_share = float(ddos_min_share)
        self._spc: Dict[str, WesternElectric] = {
            m: WesternElectric(**(spc_kw or {})) for m in self.spc_metrics}
        self._alerts: deque = deque(maxlen=int(history))
        self._callbacks: list = []
        self._lock = threading.Lock()
        self.n_windows = 0
        self.n_alerts = 0

    def on_alert(self, fn) -> None:
        """Register an alert callback (called inline from process())."""
        self._callbacks.append(fn)

    # --------------------------------------------------------- process

    def process(self, now: Optional[float] = None,
                force: bool = False) -> List[AlertReport]:
        """Close due windows and run every detector on them.  Windows
        are handled in (width, start) order, so the SPC charts consume
        seconds chronologically."""
        closed = self.rollup.close_due(now=now, force=force)
        alerts: List[AlertReport] = []
        with self._lock:
            for w in closed:
                self.n_windows += 1
                if w.level == self.spc_level:
                    alerts.extend(self._spc_step(w))
                if w.level == self.scan_level:
                    alerts.extend(self._scan_step(w))
                if w.level == self.beacon_level:
                    alerts.extend(self._beacon_step(w))
            for a in alerts:
                self._alerts.append(a)
            self.n_alerts += len(alerts)
        for a in alerts:
            for fn in self._callbacks:
                fn(a)
        return alerts

    def _spc_step(self, w: WindowSummary) -> List[AlertReport]:
        out = []
        zs: Dict[str, float] = {}
        for m in self.spc_metrics:
            rule, z = self._spc[m].update(float(getattr(w, m)))
            zs[m] = z
            if rule in self.alert_rules:
                out.append(AlertReport(
                    kind="spc", level=w.level, window_start=w.start,
                    window_stop=w.start + w.width, metric=m, rule=rule,
                    score=z, hosts=np.empty(0, dtype=str), victim="",
                    detail={"value": float(getattr(w, m))}))
        # DDoS gate: a packet-rate spike *concentrated on one dst* —
        # rate z-score joined with the window's top-dst share
        z_pkt = zs.get("n_packets", 0.0)
        if (z_pkt >= self.ddos_min_z
                and w.top_dst_share >= self.ddos_min_share and w.top_dst):
            out.append(AlertReport(
                kind="ddos", level=w.level, window_start=w.start,
                window_stop=w.start + w.width, metric="n_packets",
                rule=0, score=z_pkt, hosts=np.empty(0, dtype=str),
                victim=w.top_dst,
                detail={"top_dst_share": w.top_dst_share,
                        "n_packets": w.n_packets}))
        return out

    def _scan_step(self, w: WindowSummary) -> List[AlertReport]:
        if w.n_cells == 0:
            return []
        E = self.rollup.slice(w.start, w.start + w.width)
        if E.nnz == 0:
            return []
        hits = scan_hits(E, sep=self.rollup.sep,
                         min_fanout=self.scan_min_fanout)
        if hits.shape[0] == 0:
            return []
        return [AlertReport(
            kind="scan", level=w.level, window_start=w.start,
            window_stop=w.start + w.width, metric="", rule=0,
            score=float(w.n_dst), hosts=hits, victim="",
            detail={"min_fanout": self.scan_min_fanout,
                    "n_dst": w.n_dst})]

    def _beacon_step(self, w: WindowSummary) -> List[AlertReport]:
        if w.n_cells == 0:
            return []
        E = self.rollup.slice(w.start, w.start + w.width)
        if E.nnz == 0:
            return []
        s = c2_scores(E, sep=self.rollup.sep)
        mask = (s.scores >= self.beacon_min_score) \
            & (s.fanin >= self.beacon_min_fanin)
        if not mask.any():
            return []
        order = np.argsort(s.scores[mask])[::-1]
        hosts = s.hosts[mask][order]
        return [AlertReport(
            kind="c2", level=w.level, window_start=w.start,
            window_stop=w.start + w.width, metric="", rule=0,
            score=float(s.scores[mask].max()), hosts=hosts,
            victim=str(hosts[0]),
            detail={"fanin": float(s.fanin[mask].max()),
                    "n_candidates": int(mask.sum())})]

    # ---------------------------------------------------------- access

    def alerts(self, limit: int = 100, kind: Optional[str] = None,
               since: Optional[float] = None) -> List[AlertReport]:
        with self._lock:
            items = list(self._alerts)
        if kind is not None:
            items = [a for a in items if a.kind == kind]
        if since is not None:
            items = [a for a in items if a.window_start >= since]
        return items[-limit:]

    def stats(self) -> dict:
        with self._lock:
            kinds: Dict[str, int] = {}
            for a in self._alerts:
                kinds[a.kind] = kinds.get(a.kind, 0) + 1
            return {"n_windows": self.n_windows,
                    "n_alerts": self.n_alerts,
                    "alerts_by_kind": kinds}


class StreamAnalytics:
    """Rollup + detector bank bound to a live table's write path.

    ``attach(table)`` registers the rollup as a WriterPool ingest tap;
    from then on every drained triple block updates the rollup with no
    extra table scan.  ``step()`` (or the optional pacing thread started
    by ``start()``) closes due windows and runs the detectors.
    """

    def __init__(self, rollup: Optional[TemporalRollup] = None,
                 bank: Optional[DetectorBank] = None,
                 interval: float = 1.0, **bank_kw):
        self.rollup = rollup if rollup is not None else TemporalRollup()
        self.bank = bank if bank is not None \
            else DetectorBank(self.rollup, **bank_kw)
        self.interval = float(interval)
        self._table = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def attach(self, table) -> "StreamAnalytics":
        if self._table is not None:
            raise RuntimeError("already attached")
        table.add_ingest_tap(self.rollup.ingest)
        self._table = table
        return self

    def detach(self) -> None:
        if self._table is not None:
            self._table.remove_ingest_tap(self.rollup.ingest)
            self._table = None

    def step(self, now: Optional[float] = None,
             force: bool = False) -> List[AlertReport]:
        """One detector pass over newly closed windows."""
        return self.bank.process(now=now, force=force)

    def on_alert(self, fn) -> None:
        self.bank.on_alert(fn)

    def root_cause(self, start: float, stop: float,
                   seeds: Optional[Sequence[str]] = None,
                   top_k: int = 5, num_iters: int = 30) -> RootCauseReport:
        """Localize likely root-cause hosts for ``[start, stop)``.  With
        no explicit seeds, the most recent alert overlapping the window
        provides them (its victim, else its suspect hosts)."""
        if seeds is None:
            for a in reversed(self.bank.alerts(limit=1024)):
                if a.window_start < stop and a.window_stop > start:
                    seeds = [a.victim] if a.victim \
                        else [str(h) for h in a.hosts[:3]]
                    if seeds:
                        break
        if not seeds:
            raise ValueError("no seeds given and no overlapping alert")
        return root_cause(self.rollup, start, stop, seeds,
                          top_k=top_k, num_iters=num_iters,
                          sep=self.rollup.sep)

    # ------------------------------------------------- pacing thread

    def start(self) -> "StreamAnalytics":
        """Run ``step()`` every ``interval`` seconds on a daemon thread
        until :meth:`close` (alerts reach subscribers via on_alert)."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval):
                try:
                    self.step()
                except Exception:       # detector bug must not kill pacing
                    pass

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="stream-analytics")
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.detach()

    def stats(self) -> dict:
        return {"rollup": self.rollup.stats(), "bank": self.bank.stats()}
