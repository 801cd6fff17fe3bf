"""Fault-tolerant parallel work-queue runner (the SuperCloud scheduler analog).

The paper scales by mapping idempotent file→file tasks over thousands of
cores with a dynamic scheduler.  This runner provides the same contract
for a production deployment:

* **Checkpoint/restart** — every completion is journaled (JSONL, fsync'd);
  a restarted run skips journaled tasks.  Combined with atomic-rename
  outputs, a node can die at any instant without corrupting state.
* **Straggler mitigation** — speculative re-execution: when a task's
  runtime exceeds ``straggler_factor × p95`` of completed tasks (and a
  worker is idle), a backup copy is issued; first finisher wins.
* **Retries / fault injection** — worker crashes (simulated via
  :class:`FaultInjector` in tests) re-queue the task up to ``max_retries``.
* **Elasticity** — ``set_workers(n)`` grows/shrinks the pool while a run
  is in flight (workers drain at task boundaries).

Tasks form a DAG via ``deps``; the runner schedules any task whose
dependencies are journaled complete.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Task:
    task_id: str
    fn: Callable[[], object]          # idempotent
    deps: tuple = ()                  # "*" = every non-barrier task
    stage: str = ""                   # for per-stage stats
    # Durability coupling for tasks whose side effects are *enqueued*
    # rather than applied (async ingest): a defer_commit task completes
    # for scheduling purposes but is journaled only when a commit_point
    # task (the flush barrier, where the writes are actually applied and
    # fsync'd) finishes.  A crash in between leaves the task unjournaled,
    # so a restart re-runs it and the writes are replayed.
    defer_commit: bool = False
    commit_point: bool = False


@dataclasses.dataclass
class TaskRecord:
    task_id: str
    elapsed: float
    worker: int
    result: object = None


class WorkerKilled(RuntimeError):
    """Raised by fault injection to simulate a node failure mid-task."""


class FaultInjector:
    """Deterministically kills a fraction of task executions (tests)."""

    def __init__(self, kill_rate: float = 0.0, seed: int = 0,
                 max_kills: Optional[int] = None):
        self.kill_rate = kill_rate
        self.rng = np.random.default_rng(seed)
        self.max_kills = max_kills
        self.kills = 0
        self._lock = threading.Lock()

    def maybe_kill(self, task_id: str) -> None:
        with self._lock:
            if self.max_kills is not None and self.kills >= self.max_kills:
                return
            if self.rng.random() < self.kill_rate:
                self.kills += 1
                raise WorkerKilled(f"injected fault in {task_id}")


class Journal:
    """Append-only JSONL completion log — the restart checkpoint."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.done: Dict[str, dict] = {}
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    self.done[rec["task_id"]] = rec

    def commit(self, task_id: str, elapsed: float, stage: str) -> None:
        rec = {"task_id": task_id, "elapsed": elapsed, "stage": stage,
               "t": time.time()}
        with self._lock:
            self.done[task_id] = rec
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    try:
                        os.fsync(f.fileno())
                    except OSError:
                        pass  # non-regular file (/dev/null, some tmpfs)


class Runner:
    def __init__(self, n_workers: int = 4, journal_path: Optional[str] = None,
                 straggler_factor: float = 3.0, straggler_min_s: float = 0.25,
                 max_retries: int = 3, fault_injector: Optional[FaultInjector] = None,
                 speculative: bool = True):
        self.journal = Journal(journal_path)
        self.n_workers_target = n_workers
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self.max_retries = max_retries
        self.fault = fault_injector
        self.speculative = speculative
        # run state
        self._q: "queue.Queue[Task]" = queue.Queue()
        self._lock = threading.Lock()
        self._done: Dict[str, TaskRecord] = {}
        self._inflight: Dict[str, float] = {}   # task_id → start time
        self._retries: Dict[str, int] = {}
        self._speculated: set = set()
        self._failed: Dict[str, str] = {}
        self._elapsed_hist: List[float] = []
        self._deferred: List[tuple] = []    # (tid, elapsed, stage) awaiting
        self.stats: Dict[str, dict] = {}    # a commit-point task

    # -- elasticity ---------------------------------------------------------
    def set_workers(self, n: int) -> None:
        self.n_workers_target = n

    # -- deferred journaling -----------------------------------------------
    def commit_deferred(self) -> None:
        """Journal every completed defer_commit task.  Fired when a
        commit-point task finishes (its deps guarantee they all ran);
        also callable by the driver after an out-of-band commit — e.g.
        a restart whose barrier task was journaled in a *previous* run,
        where only the driver's trailing flush covers the fresh writes."""
        with self._lock:
            batch, self._deferred = self._deferred, []
        for tid, elapsed, stage in batch:
            self.journal.commit(tid, elapsed, stage)

    # -- core loop ------------------------------------------------------------
    def run(self, tasks: Sequence[Task]) -> Dict[str, TaskRecord]:
        # Barrier tasks: deps containing "*" expand to every non-barrier
        # task — the driver uses this for the end-of-DAG writer flush
        # (async ingest's commit point).
        plain_ids = tuple(t.task_id for t in tasks if "*" not in t.deps)
        tasks = [
            dataclasses.replace(
                t, deps=tuple(d for d in t.deps if d != "*")
                + tuple(i for i in plain_ids if i != t.task_id))
            if "*" in t.deps else t
            for t in tasks]
        by_id = {t.task_id: t for t in tasks}
        pending = {t.task_id for t in tasks
                   if t.task_id not in self.journal.done}
        for tid in set(by_id) - pending:  # restored from journal
            rec = self.journal.done[tid]
            self._done[tid] = TaskRecord(tid, rec["elapsed"], -1)

        def ready(t: Task) -> bool:
            return all(d in self._done or d in self.journal.done
                       for d in t.deps)

        scheduled: set = set()

        def schedule_ready():
            with self._lock:
                for tid in sorted(pending - scheduled):
                    if ready(by_id[tid]):
                        self._q.put(by_id[tid])
                        scheduled.add(tid)

        stop = threading.Event()
        workers: List[threading.Thread] = []

        def worker(wid: int):
            while not stop.is_set():
                if wid >= self.n_workers_target:  # elastic shrink
                    return
                try:
                    task = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
                tid = task.task_id
                with self._lock:
                    if tid in self._done:       # speculative duplicate lost
                        continue
                    self._inflight[tid] = time.time()
                t_start = time.time()
                try:
                    if self.fault is not None:
                        self.fault.maybe_kill(tid)
                    result = task.fn()
                except WorkerKilled:
                    with self._lock:
                        self._inflight.pop(tid, None)
                        n = self._retries.get(tid, 0) + 1
                        self._retries[tid] = n
                        if n <= self.max_retries:
                            self._q.put(task)   # re-issue (restart semantics)
                        else:
                            self._failed[tid] = "retries exhausted"
                            pending.discard(tid)
                    continue
                except Exception as e:  # hard task failure
                    with self._lock:
                        self._inflight.pop(tid, None)
                        n = self._retries.get(tid, 0) + 1
                        self._retries[tid] = n
                        if n <= self.max_retries:
                            self._q.put(task)
                        else:
                            self._failed[tid] = repr(e)
                            pending.discard(tid)
                    continue
                elapsed = time.time() - t_start
                first = False
                with self._lock:
                    if tid not in self._done:   # first finisher wins
                        first = True
                        self._done[tid] = TaskRecord(tid, elapsed, wid, result)
                        self._inflight.pop(tid, None)
                        pending.discard(tid)
                        self._elapsed_hist.append(elapsed)
                        st = self.stats.setdefault(
                            task.stage, {"n": 0, "total_s": 0.0})
                        st["n"] += 1
                        st["total_s"] += elapsed
                        if task.defer_commit:
                            # same locked section that marks the task
                            # done: a barrier firing the instant we
                            # release the lock must already see this
                            # entry, or the task stays unjournaled
                            self._deferred.append(
                                (tid, elapsed, task.stage))
                if first:
                    # journal/scheduling errors must never kill a worker
                    # (the task is already recorded done)
                    try:
                        if task.commit_point:
                            # the deferred tasks' writes are durable now
                            # (the barrier flushed + fsync'd them): journal
                            # them first, then the barrier itself, so a
                            # crash mid-commit never records the barrier
                            # without its ingests
                            self.commit_deferred()
                        if not task.defer_commit:
                            self.journal.commit(tid, elapsed, task.stage)
                    except Exception:
                        pass
                    schedule_ready()

        def supervisor():
            """Speculative re-execution of stragglers."""
            while not stop.is_set():
                time.sleep(0.05)
                if not self.speculative:
                    continue
                with self._lock:
                    if len(self._elapsed_hist) < 4:
                        continue
                    p95 = float(np.percentile(self._elapsed_hist, 95))
                    deadline = max(self.straggler_factor * p95,
                                   self.straggler_min_s)
                    now = time.time()
                    for tid, t0 in list(self._inflight.items()):
                        if now - t0 > deadline and tid not in self._speculated:
                            self._speculated.add(tid)
                            self._q.put(by_id[tid])  # backup copy

        schedule_ready()
        max_pool = max(self.n_workers_target, 1)
        for wid in range(max_pool):
            th = threading.Thread(target=worker, args=(wid,), daemon=True)
            th.start()
            workers.append(th)
        sup = threading.Thread(target=supervisor, daemon=True)
        sup.start()

        try:
            while pending:
                time.sleep(0.01)
                with self._lock:
                    # elastic grow: top up the pool
                    alive = sum(th.is_alive() for th in workers)
                if alive < self.n_workers_target:
                    for wid in range(alive, self.n_workers_target):
                        th = threading.Thread(target=worker, args=(wid,),
                                              daemon=True)
                        th.start()
                        workers.append(th)
                if self._failed and not self._inflight and self._q.empty():
                    break
        finally:
            stop.set()
        for th in workers:
            th.join(timeout=2.0)
        if self._failed:
            raise RuntimeError(f"tasks failed permanently: {self._failed}")
        return dict(self._done)
