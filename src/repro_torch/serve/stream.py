"""Live SSE event streams — stats ticks and streaming-detector alerts.

:class:`EventPublisher` is the shared fan-out core: a bounded replay
buffer plus a condition variable that N subscribers wait on, so N open
``/v1/stream/*`` responses cost one producer, not N pollers hammering
the counters.  Server-Sent Events is the transport (stdlib-friendly: a
long-lived ``text/event-stream`` response of ``data: <json>`` frames),
matching the no-new-deps framing style of the netstore: a browser
``EventSource``, ``curl``, or the test suite's ``http.client`` all
consume it directly.

Two producers ride it:

* :class:`StatsPublisher` — a sampler thread polls the table's merged
  ``stats()`` snapshot (a read-mostly counter read — no barriers, no
  scans, no RPCs) every ``interval`` seconds and publishes *windowed
  deltas*: rows written and cache hits/misses in the last window, the
  cache's trailing write rate, writer queue depth.
* :class:`AlertPublisher` — push-driven: registered as a
  ``DetectorBank`` alert callback, it publishes each
  :class:`~repro_torch.stream.detectors.AlertReport` the moment the detector
  pass raises it (``GET /v1/stream/alerts``).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Iterator, Optional


class EventPublisher:
    """Bounded-replay event fan-out: producers call :meth:`publish`,
    subscribers iterate :meth:`events` for SSE frames.  ``history``
    events are retained so a new subscriber can replay recent ones
    (``?replay=N``)."""

    def __init__(self, history: int = 120):
        self._samples: deque = deque(maxlen=history)
        self._cond = threading.Condition()
        self._seq = 0
        self._stopped = threading.Event()

    def publish(self, sample: dict) -> None:
        with self._cond:
            self._seq += 1
            self._samples.append((self._seq, sample))
            self._cond.notify_all()

    # -- subscription ------------------------------------------------------
    def events(self, max_events: Optional[int] = None,
               replay: int = 0, timeout: float = 30.0) -> Iterator[bytes]:
        """Yield SSE frames (``data: <json>\\n\\n`` as bytes).  Stops
        after ``max_events`` frames (None = until :meth:`close`), or
        after ``timeout`` seconds pass with no new event — a dead
        producer must not pin response threads forever."""
        sent = 0
        with self._cond:
            backlog = list(self._samples)[-replay:] if replay > 0 else []
            last_seq = self._seq if not backlog else backlog[0][0] - 1
        for seq, sample in backlog:
            yield self._frame(sample)
            last_seq = seq
            sent += 1
            if max_events is not None and sent >= max_events:
                return
        while not self._stopped.is_set():
            with self._cond:
                if self._seq <= last_seq and \
                        not self._cond.wait(timeout=timeout):
                    return              # producer stalled; end the stream
                fresh = [(s, x) for s, x in self._samples if s > last_seq]
            for seq, sample in fresh:
                yield self._frame(sample)
                last_seq = seq
                sent += 1
                if max_events is not None and sent >= max_events:
                    return

    @staticmethod
    def _frame(sample: dict) -> bytes:
        return f"data: {json.dumps(sample)}\n\n".encode()

    def latest(self) -> Optional[dict]:
        with self._cond:
            return self._samples[-1][1] if self._samples else None

    def close(self) -> None:
        self._stopped.set()
        with self._cond:
            self._cond.notify_all()


class StatsPublisher(EventPublisher):
    """Samples ``table.stats()`` on a timer; fans ticks out to SSE
    subscribers (``GET /v1/stream/stats?replay=N``)."""

    def __init__(self, table, interval: float = 1.0, history: int = 120):
        super().__init__(history=history)
        self.table = table
        self.interval = interval
        self._prev: Optional[dict] = None
        self._thread = threading.Thread(
            target=self._run, name="gateway-stats", daemon=True)
        self._thread.start()

    # -- sampling ----------------------------------------------------------
    def _run(self) -> None:
        while not self._stopped.wait(self.interval):
            self._tick()

    def _tick(self) -> dict:
        snap = self.table.stats()
        prev = self._prev or snap
        self._prev = snap
        w, pw = snap["writers"], prev["writers"]
        c, pc = snap["cache"], prev["cache"]
        sample = {
            "t": round(time.time(), 3),
            "interval_s": self.interval,
            "rows_written_window": w["n_written"] - pw["n_written"],
            "writes_per_s": round(c["writes_per_s"], 3),
            "queue_depth": w["queue_depth"],
            "pending_rows": w["pending"],
            "n_retried": w["n_retried"],
            "cache_hits_window": c["hits"] - pc["hits"],
            "cache_misses_window": c["misses"] - pc["misses"],
            "cache_entries": c["entries"],
            "admission_skips": c["admission_skips"],
            "n_entries_written_total": w["n_written"],
        }
        self.publish(sample)
        return sample

    def close(self) -> None:
        super().close()
        self._thread.join(timeout=5)


class AlertPublisher(EventPublisher):
    """Push-driven alert feed: hand :meth:`on_alert` to a
    ``DetectorBank``/``StreamAnalytics`` callback slot and every alert
    becomes an SSE frame on ``/v1/stream/alerts``."""

    def __init__(self, history: int = 256):
        super().__init__(history=history)

    def on_alert(self, alert) -> None:
        """DetectorBank callback — ``alert`` is an AlertReport."""
        self.publish(alert.to_dict())
