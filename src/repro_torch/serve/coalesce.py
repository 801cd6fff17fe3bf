"""Request coalescing: N concurrent gateway queries → one batched eval.

The batched analytics layer (``repro_torch.core.expr.eval_batch``) turns N
same-table queries into one union tablet scan and one device SpMM
launch — but HTTP requests arrive on independent threads, each holding
its own expression.  :class:`QueryCoalescer` is the meeting point: the
first arrival in an empty window becomes the *leader*, sleeps
``window`` seconds (default 3 ms — enough for a concurrent burst, below
human-visible latency), then evaluates everything that accumulated as
ONE ``eval_batch`` call and distributes the per-member results.
Followers just wait on their event; they never touch the planner.

Error semantics stay per-request: when the batch eval raises (e.g. one
member trips the degree guard), the leader falls back to member-by-
member evaluation so each request gets its *own* result or error —
one poisoned query cannot fail its neighbors.

``window <= 0`` disables coalescing (every request evaluates solo) —
the knob surfaces as ``Gateway(coalesce_window=...)``.
"""
from __future__ import annotations

import threading
import time

from ..obs.metrics import REGISTRY as _REGISTRY, obj_label as _obj_label

_M_BATCHES = _REGISTRY.counter(
    "repro_coalesce_batches_total", "Multi-member batch evals",
    labels=("coalescer",))
_M_COALESCED = _REGISTRY.counter(
    "repro_coalesce_coalesced_total", "Requests served by a batched eval",
    labels=("coalescer",))
_M_SOLO = _REGISTRY.counter(
    "repro_coalesce_solo_total",
    "Single-member windows (plus every request while disabled)",
    labels=("coalescer",))


class _Pending:
    __slots__ = ("expr", "result", "error", "done")

    def __init__(self, expr):
        self.expr = expr
        self.result = None
        self.error = None
        self.done = threading.Event()


class QueryCoalescer:
    """Leader-based window batching over ``eval_batch``.

    Stats: ``n_batches`` counts multi-member batch evals, ``n_coalesced``
    the requests served by them, ``n_solo`` the single-member windows
    (plus every request while disabled), ``max_batch`` the largest batch
    seen — the bench/CI signal that coalescing actually engaged.
    """

    def __init__(self, window: float = 0.003, clock=time.monotonic,
                 sleep=time.sleep):
        self.window = window
        self.clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._pending: list = []
        self.metrics_label = _obj_label("coalescer")
        lab = dict(coalescer=self.metrics_label)
        self._m_batches = _M_BATCHES.labels(**lab)
        self._m_coalesced = _M_COALESCED.labels(**lab)
        self._m_solo = _M_SOLO.labels(**lab)
        self.max_batch = 0

    # registry-backed counter reads (compat: pre-obs attribute shapes)
    @property
    def n_batches(self) -> int:
        return self._m_batches.value

    @property
    def n_coalesced(self) -> int:
        return self._m_coalesced.value

    @property
    def n_solo(self) -> int:
        return self._m_solo.value

    def eval(self, expr):
        """Evaluate a deferred expression, batched with any concurrent
        callers inside one window.  Blocks until this request's result
        (or error) is ready."""
        if self.window <= 0:
            self._m_solo.inc()
            return expr.eval()
        p = _Pending(expr)
        with self._lock:
            is_leader = not self._pending
            self._pending.append(p)
        if is_leader:
            self._sleep(self.window)
            with self._lock:
                batch, self._pending = self._pending, []
            self._run(batch)
        p.done.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def _run(self, batch: list) -> None:
        from ..core.expr import eval_batch
        if len(batch) >= 2:
            self._m_batches.inc()
            self._m_coalesced.inc(len(batch))
        else:
            self._m_solo.inc()
        with self._lock:
            self.max_batch = max(self.max_batch, len(batch))
        try:
            results = eval_batch([p.expr for p in batch])
            for p, r in zip(batch, results):
                p.result = r
        except Exception:
            # per-request error semantics: re-evaluate member by member
            # (already-computed members return their cached value)
            for p in batch:
                try:
                    p.result = p.expr.eval()
                except Exception as e:      # noqa: BLE001 — delivered
                    p.error = e             # to the request thread
        finally:
            for p in batch:
                p.done.set()

    def stats(self) -> dict:
        with self._lock:
            return {"window_s": self.window, "n_batches": self.n_batches,
                    "n_coalesced": self.n_coalesced, "n_solo": self.n_solo,
                    "max_batch": self.max_batch}
