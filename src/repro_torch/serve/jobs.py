"""Background job queue for long analytics.

PageRank over the whole graph or a full-table power-law fit can take
longer than an interactive HTTP request should hold a connection, and
running them on gateway request threads would starve the cheap query
endpoints.  Jobs decouple the two: ``POST /v1/jobs`` enqueues, a small
bounded worker pool executes, and the client polls
``GET /v1/jobs/<id>`` until ``done`` then fetches the result.

Bounds, because a serving tier must fail fast rather than buffer
unboundedly:

* ``max_queued`` — total queued jobs; beyond it submission raises
  :class:`QueueFull` → HTTP 503 (the cluster is saturated, retry later);
* per-tenant ``max_jobs`` (from :class:`~repro_torch.serve.auth.Tenant`) —
  one tenant cannot occupy the whole queue;
* ``result_ttl`` — finished jobs are dropped after this many seconds
  (first-poll-after-expiry sweeps them), bounding result memory.

Results must already be JSON-serializable — job functions return
``to_dict()``-style payloads (see ``repro_torch.serve.routes``).
"""
from __future__ import annotations

import queue
import secrets
import threading
import time
import weakref
from typing import Callable, Dict, Optional

from ..obs.metrics import REGISTRY as _REGISTRY, obj_label as _obj_label
from .auth import Tenant

_M_SUBMITTED = _REGISTRY.counter(
    "repro_jobs_submitted_total", "Jobs accepted into the queue",
    labels=("jobs",))
_M_COMPLETED = _REGISTRY.counter(
    "repro_jobs_completed_total", "Jobs finished successfully",
    labels=("jobs",))
_M_FAILED = _REGISTRY.counter(
    "repro_jobs_failed_total", "Jobs that raised or were shut down",
    labels=("jobs",))
_M_JOB_COALESCED = _REGISTRY.counter(
    "repro_jobs_coalesced_total",
    "Submissions that rode a queued primary via batch_key",
    labels=("jobs",))
_M_JOB_DEPTH = _REGISTRY.gauge(
    "repro_jobs_queue_depth", "Queued + running jobs", labels=("jobs",))


class QueueFull(Exception):
    """The job queue is at capacity; mapped to HTTP 503."""
    status = 503


class UnknownJob(KeyError):
    """No such job id (or its result already expired); HTTP 404."""
    status = 404


class Job:
    __slots__ = ("id", "kind", "tenant", "status", "result", "error",
                 "submitted_at", "started_at", "finished_at",
                 "batch_key", "followers")

    def __init__(self, kind: str, tenant: str, clock=time.monotonic):
        self.id = secrets.token_hex(8)
        self.kind = kind
        self.tenant = tenant
        self.status = "queued"          # queued | running | done | failed
        self.result = None
        self.error: Optional[str] = None
        self.submitted_at = clock()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.batch_key: Optional[str] = None
        # jobs coalesced onto this one while it was queued: they share
        # its execution and receive copies of its result/status
        self.followers: list = []

    def describe(self) -> dict:
        out = {"job": self.id, "kind": self.kind, "tenant": self.tenant,
               "status": self.status}
        if self.error is not None:
            out["error"] = self.error
        return out


class JobQueue:
    """Bounded worker threads draining a FIFO of analytics jobs."""

    def __init__(self, n_workers: int = 2, max_queued: int = 64,
                 result_ttl: float = 600.0, clock=time.monotonic):
        self.max_queued = max_queued
        self.result_ttl = result_ttl
        self.clock = clock
        self._q: "queue.Queue" = queue.Queue()
        self._jobs: Dict[str, Job] = {}
        self._coalesce: Dict[str, Job] = {}     # batch_key → queued primary
        self._lock = threading.Lock()
        self.metrics_label = _obj_label("jobs")
        lab = dict(jobs=self.metrics_label)
        self._m_submitted = _M_SUBMITTED.labels(**lab)
        self._m_completed = _M_COMPLETED.labels(**lab)
        self._m_failed = _M_FAILED.labels(**lab)
        self._m_coalesced = _M_JOB_COALESCED.labels(**lab)
        self._m_depth = _M_JOB_DEPTH.labels(**lab)
        ref = weakref.ref(self)
        self._m_depth.set_function(lambda: ref().live_jobs)
        self._closed = threading.Event()
        self._workers = [
            threading.Thread(target=self._work, name=f"gateway-job/{i}",
                             daemon=True)
            for i in range(max(n_workers, 1))]
        for w in self._workers:
            w.start()

    @property
    def n_coalesced(self) -> int:
        """Registry-backed compat shape for the pre-obs attribute."""
        return self._m_coalesced.value

    @property
    def live_jobs(self) -> int:
        with self._lock:
            return sum(1 for j in self._jobs.values()
                       if j.status in ("queued", "running"))

    # -- submission / polling ----------------------------------------------
    def submit(self, kind: str, fn: Callable[[], dict],
               tenant: Tenant, batch_key: Optional[str] = None) -> Job:
        """Enqueue ``fn``; raises :class:`QueueFull` when the global or
        per-tenant bound is hit.

        With a ``batch_key``, identical work coalesces per queue drain:
        if a job with the same key is still *queued*, the new submission
        becomes a follower — its own :class:`Job` id (per-tenant bounds
        still apply), but no second execution; the worker copies the
        primary's result/status to every follower when it finishes.
        Running or finished jobs never absorb followers (their snapshot
        may predate the new request's writes).
        """
        with self._lock:
            self._sweep_locked()
            live = [j for j in self._jobs.values()
                    if j.status in ("queued", "running")]
            if len(live) >= self.max_queued:
                raise QueueFull(f"job queue full ({self.max_queued} live)")
            mine = sum(1 for j in live if j.tenant == tenant.name)
            if mine >= tenant.max_jobs:
                raise QueueFull(
                    f"tenant {tenant.name!r} at its job bound "
                    f"({tenant.max_jobs})")
            job = Job(kind, tenant.name, clock=self.clock)
            self._jobs[job.id] = job
            if batch_key is not None:
                primary = self._coalesce.get(batch_key)
                if primary is not None and primary.status == "queued":
                    primary.followers.append(job)
                    self._m_coalesced.inc()
                    self._m_submitted.inc()
                    return job          # rides the primary's execution
                job.batch_key = batch_key
                self._coalesce[batch_key] = job
        self._m_submitted.inc()
        self._q.put((job, fn))
        return job

    def get(self, job_id: str) -> Job:
        with self._lock:
            self._sweep_locked()
            job = self._jobs.get(job_id)
        if job is None:
            raise UnknownJob(job_id)
        return job

    def _sweep_locked(self) -> None:
        now = self.clock()
        dead = [jid for jid, j in self._jobs.items()
                if j.finished_at is not None
                and now - j.finished_at > self.result_ttl]
        for jid in dead:
            del self._jobs[jid]

    # -- execution ---------------------------------------------------------
    def _work(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            job, fn = item
            with self._lock:
                # the drain point: no further followers may attach —
                # later identical submissions start a fresh primary
                if job.batch_key is not None:
                    self._coalesce.pop(job.batch_key, None)
                group = [job] + job.followers
            if self._closed.is_set():
                for j in group:
                    j.status = "failed"
                    j.error = "gateway shutting down"
                    j.finished_at = self.clock()
                self._m_failed.inc(len(group))
                continue
            for j in group:
                j.status = "running"
                j.started_at = self.clock()
            try:
                result = fn()
                for j in group:
                    j.result = result
                    j.status = "done"
                self._m_completed.inc(len(group))
            except Exception as e:      # surfaced via the status poll
                for j in group:
                    j.error = f"{type(e).__name__}: {e}"
                    j.status = "failed"
                self._m_failed.inc(len(group))
            finally:
                now = self.clock()
                for j in group:
                    j.finished_at = now

    def close(self) -> None:
        """Stop the workers; queued-but-unstarted jobs fail fast."""
        self._closed.set()
        for _ in self._workers:
            self._q.put(None)
        for w in self._workers:
            w.join(timeout=5)

    def stats(self) -> dict:
        with self._lock:
            by_status: Dict[str, int] = {}
            for j in self._jobs.values():
                by_status[j.status] = by_status.get(j.status, 0) + 1
        return {"by_status": by_status, "n_workers": len(self._workers),
                "max_queued": self.max_queued,
                "n_coalesced": self.n_coalesced}
