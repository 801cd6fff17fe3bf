"""Async batched writers — the binding layer's parallel ingest path.

The paper's ingest result (§IV-F: 8×16-node instances out-ingest one
128-node instance) and its follow-ons (arXiv:1907.04217's 1.9B
updates/sec, arXiv:1902.00846's hierarchical in-memory buffering) all
rest on one mechanism: **independent write paths kept busy with large
coalesced batches**.  The synchronous ``DBTable.put`` loop leaves that
on the table — each batch blocks the caller through every instance's
coordination stall in turn.

:class:`WriterPool` restores the overlap with a two-tier hierarchy:

* **tier 1 — caller-local buffers**: ``submit`` hash-partitions a triple
  batch and appends to per-instance buffers (no locks contended, no
  thread wake-ups on the hot path); a buffer *spills* to its writer
  queue as one coalesced block once it holds ``spill_rows`` rows;
* **tier 2 — per-instance writer threads**: one thread per
  :class:`~repro_torch.db.edgestore.EdgeStore` instance drains its queue,
  further coalescing everything queued into a single mutation — so the
  instance's per-batch coordination stall is paid once per drain, not
  once per submitted batch, and stalls overlap across instances.

Guarantees:

* **per-instance ordering** — buffers, queues, and the single writer
  thread are all FIFO; row-hash partitioning sends a given row to the
  same instance every time, so per-key last-write-wins order holds;
* **bounded memory** — buffers spill at ``spill_rows``; queues have
  ``maxsize`` (backpressure, not unbounded buffering);
* **flush barrier** — :meth:`flush` spills every buffer and returns only
  when every block queued *before the call* is applied (mutations
  visible to scans); :meth:`drain` is the same wait without the
  durability fsync — the binding's read barrier, so gateway reader
  threads are never serialized behind ingest that keeps arriving while
  they wait (each barrier is a snapshot of the spill sequence, not a
  wait for an empty queue);
* **bounded retry** — a failed block is re-put with exponential backoff
  (``max_retries`` per block, Accumulo BatchWriter semantics); the
  single writer thread retries in place, so per-instance FIFO order is
  preserved across retries;
* **error propagation** — a block that exhausts its retries is recorded
  and re-raised as :class:`AsyncWriterError` from the next ``submit``,
  ``flush``, or ``close`` (the writer keeps draining so barriers never
  hang; the dead block's writes are lost — the caller decides whether
  to re-put).

Durability contract: an async ``put`` is *applied* no later than the
next ``flush()`` — the pipeline's stage-6 tasks enqueue and return, and
the driver's end-of-DAG flush barrier is the commit point (see
``pipeline/driver.py``).  On durable backends (anything exposing
``sync()``, e.g. :class:`~repro_torch.db.lsmstore.LSMStore`) ``flush`` also
fsyncs the WAL, so the barrier commits to disk, not just to memory.
"""
from __future__ import annotations

import queue
import threading
import time
import weakref
import zlib
from typing import Optional

import numpy as np

from ..obs.metrics import REGISTRY as _REGISTRY, obj_label as _obj_label
from ..obs.trace import span as _span

_STOP = object()

# Writer-pool metric families: one labeled child per live pool (the pool
# keeps the only strong ref).  n_written / n_retried / tap_errors are
# properties over these children — one count, read by both stats() and
# /metrics.  The gauges read live pool state at scrape via weakref.
_M_WRITTEN = _REGISTRY.counter(
    "repro_writer_written_total", "Triples applied by writer threads",
    labels=("pool",))
_M_RETRIED = _REGISTRY.counter(
    "repro_writer_retried_total",
    "Blocks that succeeded only after at least one retry",
    labels=("pool",))
_M_WRITE_ERRORS = _REGISTRY.counter(
    "repro_writer_errors_total",
    "Blocks that exhausted their retries (writes lost)", labels=("pool",))
_M_TAP_ERRORS = _REGISTRY.counter(
    "repro_writer_tap_errors_total",
    "Ingest-tap callbacks that raised (counted, never propagated)",
    labels=("pool",))
_M_PENDING = _REGISTRY.gauge(
    "repro_writer_pending",
    "Rows buffered plus blocks enqueued but not yet applied",
    labels=("pool",))
_M_QUEUE_DEPTH = _REGISTRY.gauge(
    "repro_writer_queue_depth", "Blocks sitting in writer queues",
    labels=("pool",))


def _stable_key_hash(k: str) -> int:
    """Fallback routing hash for backends without a ``key_hash`` hook:
    crc32, matching ``LSMMultiInstanceDB.key_hash`` — ``pin=``-based
    file→instance routing must agree across producer processes, and
    Python's ``hash()`` is process-salted."""
    return zlib.crc32(k.encode())


class AsyncWriterError(RuntimeError):
    """A background writer thread failed; raised at the next barrier."""


class _InstanceWriter:
    """One store's write path: a bounded queue drained by one thread."""

    def __init__(self, store, maxsize: int, pool: "WriterPool"):
        self.store = store
        self.pool = pool
        self.q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.buf: list = []          # tier-1 buffer, guarded by pool lock
        self.buf_rows = 0
        # spill-sequence barrier state: blocks are queued as
        # (seq, block); applied_seq advances (under cond) once a block's
        # mutation has landed — error or not, so barriers never hang.
        # Barriers snapshot spilled_seq and wait for applied_seq to
        # reach it, which waits only on blocks that *preceded* the
        # barrier, never on ingest still arriving behind it.
        self.spilled_seq = 0         # guarded by pool lock (spill path)
        self.applied_seq = 0         # guarded by cond
        self.cond = threading.Condition()
        self.thread = threading.Thread(
            target=self._loop, name=f"writer/{store.name}", daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        while True:
            # tier-2 coalescing: drain everything queued and apply it as
            # ONE mutation — one coordination stall per drain, not per
            # submitted batch.
            items = [self.q.get()]
            try:
                while True:
                    items.append(self.q.get_nowait())
            except queue.Empty:
                pass
            stop = any(it is _STOP for it in items)
            batches = [it for it in items if it is not _STOP]
            # any failure (even concatenation OOM) must be recorded, and
            # task_done must run, or flush()'s q.join() hangs forever
            try:
                if batches:
                    r = np.concatenate([b[0] for (_, b) in batches])
                    c = np.concatenate([b[1] for (_, b) in batches])
                    v = np.concatenate([b[2] for (_, b) in batches])
                    self._apply_with_retry(r, c, v)
            except BaseException as e:  # noqa: BLE001 — propagate at barrier
                self.pool._record_error(e)
            finally:
                if batches:
                    with self.cond:
                        self.applied_seq = max(self.applied_seq,
                                               *(s for (s, _) in batches))
                        self.cond.notify_all()
                for _ in items:
                    self.q.task_done()
            if stop:
                return

    def _await_applied(self, seq: int) -> None:
        """Block until every block spilled at or before ``seq`` has been
        applied (or recorded as failed — ``applied_seq`` advances either
        way, so a dead block can never wedge a barrier)."""
        with self.cond:
            while self.applied_seq < seq:
                self.cond.wait()

    def _apply_with_retry(self, r, c, v) -> None:
        """Re-put a failed block with bounded exponential backoff
        (Accumulo BatchWriter semantics).  Retrying in place on the
        single writer thread keeps per-instance FIFO order; a block
        that exhausts ``max_retries`` is recorded for the next barrier."""
        for attempt in range(self.pool.max_retries + 1):
            try:
                fault = self.pool.fault_injector
                if fault is not None:
                    fault.maybe_kill(f"writer/{self.store.name}")
                self.pool._m_written.inc(self.store.put_triples(r, c, v))
                if attempt:
                    self.pool._m_retried.inc()
                self.pool._notify_taps(r, c, v)
                return
            except BaseException as e:  # noqa: BLE001 — propagate at barrier
                if attempt >= self.pool.max_retries:
                    self.pool._record_error(e)
                    return
                time.sleep(min(self.pool.retry_backoff_s * (2 ** attempt),
                               self.pool.retry_backoff_max_s))


class WriterPool:
    """Background writer pool over any registered backend (EdgeStore,
    MultiInstanceDB, LSMStore, or their multi-instance fan-outs).

    One writer thread per instance.  ``submit`` partitions a triple batch
    by row hash across instances (mirroring
    :meth:`MultiInstanceDB.put_triples`) or pins it to one instance when
    ``pin`` (a file id) is given — the paper's file→instance routing.
    """

    def __init__(self, backend, maxsize: int = 32,
                 spill_rows: int = 25_000, fault_injector=None,
                 max_retries: int = 2, retry_backoff_s: float = 0.05,
                 retry_backoff_max_s: float = 2.0):
        # duck-typed so any registered backend works: a multi-instance
        # store exposes .instances; a single instance exposes the
        # EdgeStore write protocol directly
        if hasattr(backend, "instances"):
            stores = list(backend.instances)
        elif callable(getattr(backend, "put_triples", None)):
            stores = [backend]
        else:
            raise TypeError(f"cannot attach writers to {type(backend)!r}")
        self.backend = backend
        # partition with the backend's own routing hash — durable
        # backends use a process-stable hash so queued writes land in
        # the same instance directories as every other process's
        self._key_hash = getattr(backend, "key_hash",
                                 None) or _stable_key_hash
        self.spill_rows = spill_rows
        self.fault_injector = fault_injector
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_max_s = retry_backoff_max_s
        self._lock = threading.Lock()       # guards tier-1 buffers
        # errors get their own lock: _spill can block on a full queue
        # while holding _lock, and the writer thread must still be able
        # to record a failure (and free a queue slot) without deadlock
        self._err_lock = threading.Lock()
        self._errors: list[BaseException] = []
        self._closed = False
        # ingest taps: callables observing every applied block *as it
        # drains* (streaming rollups ride this — no extra table scan).
        # Registration is copy-on-write so _notify_taps never locks.
        self._taps: tuple = ()
        self.metrics_label = _obj_label("pool")
        lab = dict(pool=self.metrics_label)
        self._m_written = _M_WRITTEN.labels(**lab)
        self._m_retried = _M_RETRIED.labels(**lab)
        self._m_write_errors = _M_WRITE_ERRORS.labels(**lab)
        self._m_tap_errors = _M_TAP_ERRORS.labels(**lab)
        self._m_pending = _M_PENDING.labels(**lab)
        self._m_queue_depth = _M_QUEUE_DEPTH.labels(**lab)
        # live-read gauges: weakref-closing so the gauge (held weakly by
        # its family anyway) never resurrects or pins a closed pool
        ref = weakref.ref(self)
        self._m_pending.set_function(lambda: ref().pending)
        self._m_queue_depth.set_function(lambda: ref().queue_depth)
        self._writers = [_InstanceWriter(s, maxsize, self) for s in stores]

    # -- ingest taps --------------------------------------------------------
    def add_tap(self, fn) -> None:
        """Register ``fn(rows, cols, vals)`` to observe each triple block
        right after its mutation lands (called on the writer thread, so a
        slow tap backpressures that instance's queue — keep taps cheap).
        A tap exception is counted, not propagated: observers must never
        fail ingest."""
        with self._err_lock:
            self._taps = self._taps + (fn,)

    def remove_tap(self, fn) -> None:
        with self._err_lock:
            self._taps = tuple(t for t in self._taps if t is not fn)

    def _notify_taps(self, r, c, v) -> None:
        for fn in self._taps:
            try:
                fn(r, c, v)
            except BaseException:   # noqa: BLE001 — observer, not writer
                self._m_tap_errors.inc()

    # -- error plumbing ----------------------------------------------------
    def _record_error(self, e: BaseException) -> None:
        self._m_write_errors.inc()
        with self._err_lock:
            self._errors.append(e)

    def _check(self) -> None:
        with self._err_lock:
            if self._errors:
                e = self._errors[0]
                raise AsyncWriterError(
                    f"{len(self._errors)} async write block(s) failed; "
                    f"first: {e!r}") from e

    # -- ingest ------------------------------------------------------------
    def submit(self, r: np.ndarray, c: np.ndarray, v: np.ndarray,
               pin: Optional[str] = None) -> int:
        """Buffer a triple batch; spills to the writers once the
        per-instance buffer reaches ``spill_rows``.  Blocks only on
        queue backpressure during a spill."""
        self._check()
        if self._closed:
            raise RuntimeError("writer pool is closed")
        n = int(np.asarray(r).shape[0])
        if not n:
            return 0
        nw = len(self._writers)
        # partition outside the lock — the O(n) hashing must not
        # serialize concurrent producers; the lock only covers appends
        if nw == 1:
            parts = [(0, (r, c, v), n)]
        elif pin is not None:
            parts = [(self._key_hash(pin) % nw, (r, c, v), n)]
        else:
            h = np.asarray([self._key_hash(k) for k in r], dtype=np.int64)
            part = h % nw
            parts = []
            for i in np.unique(part):
                m = part == i
                parts.append((int(i), (r[m], c[m], v[m]), int(m.sum())))
        with self._lock:
            for i, item, ni in parts:
                self._buffer(self._writers[i], item, ni)
        return n

    def _buffer(self, w: _InstanceWriter, item, n: int) -> None:
        """Tier-1 append; spill when full.  Caller holds the lock."""
        w.buf.append(item)
        w.buf_rows += n
        if w.buf_rows >= self.spill_rows:
            self._spill(w)

    def _spill(self, w: _InstanceWriter) -> None:
        if not w.buf:
            return
        if len(w.buf) == 1:
            block = w.buf[0]
        else:
            block = tuple(np.concatenate([b[i] for b in w.buf])
                          for i in range(3))
        w.buf = []
        w.buf_rows = 0
        w.spilled_seq += 1
        w.q.put((w.spilled_seq, block))

    # -- barriers ----------------------------------------------------------
    def _barrier(self) -> None:
        """Spill every buffer, then wait for the *snapshot* of spilled
        blocks to apply.  Ingest submitted while we wait does not extend
        the wait — the property that keeps many concurrent reader
        barriers live during sustained ingest."""
        with self._lock:
            for w in self._writers:
                self._spill(w)
            targets = [(w, w.spilled_seq) for w in self._writers]
        for w, seq in targets:
            w._await_applied(seq)
        self._check()

    def drain(self) -> None:
        """Visibility barrier (the binding's read path): all ``submit``\\ s
        that happened before this call are applied and visible to scans.
        No durability fsync — reads need visibility, not persistence —
        so on LSM/net backends concurrent readers skip the WAL/RPC sync
        entirely."""
        self._barrier()

    def flush(self) -> None:
        """Durability barrier: :meth:`drain` semantics *plus* the backend
        fsync; re-raises writer errors.  After ``flush`` returns cleanly,
        all prior ``submit``\\ s are visible to scans and, on a durable
        backend, committed to disk (the WAL commit point)."""
        self._barrier()
        self._sync_backend()

    def _sync_backend(self) -> None:
        sync = getattr(self.backend, "sync", None)
        if sync is not None:
            with _span("backend.sync"):
                sync()

    def close(self) -> None:
        """Flush, stop the writer threads, and re-raise pending errors."""
        if self._closed:
            self._check()
            return
        self._closed = True
        with self._lock:
            for w in self._writers:
                self._spill(w)
        for w in self._writers:
            w.q.put(_STOP)
        for w in self._writers:
            w.thread.join()
        self._check()
        self._sync_backend()
        # the writers' back-pointers make pool <-> writer a reference
        # cycle; cut it so a closed pool (and the backend it pins) frees
        # by refcount instead of waiting on a gen-2 gc pass
        for w in self._writers:
            w.pool = None

    # -- introspection -----------------------------------------------------
    @property
    def pending(self) -> int:
        """Rows buffered plus blocks enqueued but not yet applied.  Read
        under the pool lock: ``buf_rows`` moves to ``unfinished_tasks``
        at spill time while that lock is held, so a locked read can't
        see a row in both tiers (or neither) mid-spill."""
        with self._lock:
            return (sum(w.buf_rows for w in self._writers)
                    + sum(w.q.unfinished_tasks for w in self._writers))

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return sum(w.q.qsize() for w in self._writers)

    # registry-backed counter reads (compat: pre-obs attribute shapes)
    @property
    def n_written(self) -> int:
        return self._m_written.value

    @property
    def n_retried(self) -> int:
        """Blocks that succeeded only after at least one retry."""
        return self._m_retried.value

    @property
    def tap_errors(self) -> int:
        return self._m_tap_errors.value

    def stats(self) -> dict:
        """Counter snapshot (merged into ``DBTable.stats()``).  The
        queue-state pair is taken in one locked pass so ``pending`` /
        ``queue_depth`` can't tear against a concurrent spill."""
        with self._err_lock:
            n_err = len(self._errors)
        with self._lock:
            pending = (sum(w.buf_rows for w in self._writers)
                       + sum(w.q.unfinished_tasks for w in self._writers))
            depth = sum(w.q.qsize() for w in self._writers)
        return {"pending": pending,
                "queue_depth": depth,
                "n_written": self.n_written,
                "n_retried": self.n_retried,
                "n_errors": n_err,
                "n_writers": len(self._writers),
                "n_taps": len(self._taps),
                "tap_errors": self.tap_errors}

    def __repr__(self) -> str:
        return (f"WriterPool({len(self._writers)} writer(s), "
                f"pending={self.pending}, written={self.n_written})")
