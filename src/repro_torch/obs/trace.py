"""Request-scoped tracing: spans from the gateway down to kernel launch.

The serving stack spans six layers (gateway → planner → binding →
WriterPool → LSM/net backend → device kernels); per-object counters say
*how much* work each layer did, but not *which request* paid for it.  A
:class:`Span` answers that: the gateway opens a root span per traced
request, and every instrumented layer underneath attaches child spans —
scan route + cache verdict, the writer drain barrier, each per-shard
RPC (tagged with the shard address), LSM spill/compaction, each device
kernel launch — giving one tree per request that shows exactly where
the budget went.

Design constraints, in priority order:

1. **The untraced hot path stays O(ns).**  Propagation rides a
   :mod:`contextvars` ContextVar; when no trace is active,
   :func:`span` does one ContextVar read and returns a shared no-op —
   no allocation beyond the kwargs dict, no lock, no clock read.
   Layers therefore instrument unconditionally; *sampling is decided
   once, at the gateway* (``?trace=1``, an ``X-Trace-Id`` header, or
   the ``sample`` probability knob).
2. **Bounded memory.**  Finished spans land in a per-:class:`Tracer`
   ring: at most ``max_traces`` traces (LRU-evicted), at most
   ``max_spans`` spans per trace (excess counted, not stored).
3. **Same-thread propagation only.**  Scans, RPC streams, barriers and
   kernel launches all execute on the requesting thread, so ContextVar
   scoping is exactly right; background writer/job threads are *not*
   in the request's critical path and stay untraced.

The tracer doubles as the **slow-query log**: the ``slow_log_size``
slowest root spans over ``slow_threshold_s`` keep their full span tree
(``/v1/debug/slow``); untraced requests that cross the threshold are
noted tree-less by the gateway (:meth:`Tracer.note_slow`) so a slow
query never hides just because it wasn't sampled.

**One clock with the device trace.**  While a ``torch.profiler`` is
recording (``torch.autograd.profiler._is_profiler_enabled``, read
through ``sys.modules`` so this module imports no torch), a live span
also enters ``torch.profiler.record_function(name)`` for its extent.
Any profiler trace (``export_chrome_trace``, ``key_averages``) then
holds the program's spans on its own clock, each kernel under the span
that enqueued it; the copies on the card's timeline arrive flagged
``is_user_annotation``.  The no-op path, :func:`record` and
:func:`traced_iter` are not mirrored.

Span catalog (name: layer; tags; who reads it — the benchmark's
per-layer metrics live in ``bench/metrics/``):

* ``<METHOD> <path>``: gateway root (``serve.app``); ``method``,
  ``path``; ``/v1/trace``, the slow log.  The benchmark's loops open
  one root a call instead, named after the call.
* ``planner.eval`` (``op``), ``planner.eval_batch`` (``n``): the
  planner's entry points (``core.expr``); their self time is planning
  and, in a batch, the fused chains' multi-vector assembly.
* ``planner.exec.<op>`` for ``scan``, ``select``, ``transpose``,
  ``add``, ``sub``, ``emul``, ``matmul``, ``sum`` and ``fused`` (one
  per node the executor runs; leaves, memo hits and nodes evaluated
  before record nothing): the executor's host work; ``nnz``, ``shape``
  of the output, ``route`` (``chain``/``spmv``/``host``) on ``matmul``
  and (``device``/``host``) on ``sum``, ``ops`` on ``fused``;
  ``planner.exec_ms``.
* ``planner.exec.align``: ``keys.align`` and ``Assoc._onto`` before a
  product, on every route; ``path`` (``same``/``empty``/``search``/
  ``merge``, the aligner's path, also counted in
  ``repro_key_align_total``); ``planner.exec_ms``.
* ``kernel.spmv`` (``nnz``), ``kernel.spmm`` (``nnz``, ``b``): the
  device lowering's ELL pack, copy to the card and enqueue;
  ``planner.lowering_ms``.
* ``db.scan`` (``table``, ``cache`` = ``hit``/``miss``),
  ``db.scan_batch`` (``table``, ``n``, ``hits``, ``misses``): the
  binding and its ScanCache; ``db.scan_ms``, ``db.scan_cache_hit_pct``.
* ``writer.drain``, ``backend.sync``: the write path's barriers;
  ``/v1/trace``.
* ``rpc.<op>`` (``shard``): the net store's client; ``db.rpc_ms``.
* ``lsm.spill``, ``lsm.compact``, ``lsm.scan_*``, ``lsm.degree_items``:
  the LSM store; ``/v1/trace``.
* ``analytics.fit_degree_table``, ``analytics.c2_scores`` with
  ``analytics.c2.{fanin,uniform,beacon,ports,fuse}``, and
  ``analytics.pagerank_table`` with
  ``analytics.pagerank.{adjacency,square,upload,iterate}``: the
  analytics' host work outside the planner (key strips, ``Assoc``
  builds, statistics, uploads, enqueues); ``analytics.host_ms``.
* ``model.prefill`` (``batch``, ``tokens``), ``model.decode_step``
  (``batch``): ``launch.serve.generate``'s prompt pass and each decode
  step, each ending once the step's tokens are on the host;
  ``model.prefill_ms``, ``model.decode_step_ms``, and the steps the
  roofline readers attribute kernels to.  Within a step each attention
  layer counts its route over the K/V rings in
  ``repro_attn_decode_total{path}`` (``grouped``/``expanded``,
  ``models.blocks.apply_attn``, traced or not); no metric reads it.
* ``moe.route`` (``rows``, ``experts_hit``), ``moe.experts`` (``rows``,
  ``experts_hit``): the dropless expert layer's routing and grouped
  products (``models.blocks.apply_moe_grouped``; a traced call reads the
  pairs an expert back to the host for ``experts_hit`` and
  ``repro_moe_pairs_total{expert}``); ``moe.grouped_roofline``.
"""
from __future__ import annotations

import contextvars
import itertools
import os
import sys
import threading
import time
from collections import OrderedDict
from typing import Iterable, Optional

__all__ = ["Tracer", "span", "current_ctx", "record", "traced_iter"]

_CTX: "contextvars.ContextVar[Optional[_Ctx]]" = contextvars.ContextVar(
    "repro_trace_ctx", default=None)


class _Ctx:
    """The active (tracer, trace, parent-span) triple a thread carries."""

    __slots__ = ("tracer", "trace_id", "span_id")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: int):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id


def current_ctx() -> Optional[_Ctx]:
    """The active trace context, or None when untraced — generators that
    outlive their creating frame capture this once and :func:`record`
    against it instead of entering a ``with`` block across yields."""
    return _CTX.get()


class _NoopSpan:
    """What :func:`span` returns when no trace is active."""

    __slots__ = ()
    trace_id = None
    live = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **kw):
        pass


_NOOP = _NoopSpan()


class _Span:
    """A live span: context manager that re-parents the ContextVar for
    its dynamic extent and records itself on exit."""

    __slots__ = ("_ctx", "name", "tags", "_t0", "_wall0", "_sid", "_token",
                 "_rf")
    live = True

    def __init__(self, ctx: _Ctx, name: str, tags: dict):
        self._ctx = ctx
        self.name = name
        self.tags = tags
        self._rf = None

    @property
    def trace_id(self) -> str:
        return self._ctx.trace_id

    def __enter__(self):
        ctx = self._ctx
        self._sid = ctx.tracer._next_span_id()
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is not None and prof._is_profiler_enabled:
            # the same extent on the profiler's clock (module docstring)
            self._rf = prof.record_function(self.name)
            self._rf.__enter__()
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        self._token = _CTX.set(_Ctx(ctx.tracer, ctx.trace_id, self._sid))
        return self

    def tag(self, **kw) -> None:
        self.tags.update(kw)

    def __exit__(self, et, ev, tb):
        dur = time.perf_counter() - self._t0
        _CTX.reset(self._token)
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
            self._rf = None
        if et is not None:
            self.tags["error"] = f"{et.__name__}: {ev}"
        ctx = self._ctx
        ctx.tracer._record(ctx.trace_id, self._sid, ctx.span_id,
                           self.name, self._wall0, dur, self.tags)
        return False


def span(name: str, **tags):
    """Open a child span under the current trace — or a shared no-op
    when untraced (the O(ns) fast path; see module docstring)."""
    ctx = _CTX.get()
    if ctx is None:
        return _NOOP
    return _Span(ctx, name, tags)


def record(ctx: Optional[_Ctx], name: str, wall0: float, dur: float,
           **tags) -> None:
    """Append a completed span under ``ctx`` without touching the
    ContextVar — the escape hatch for generators whose extent spans
    many resumptions (RPC streams, LSM scans)."""
    if ctx is not None:
        ctx.tracer._record(ctx.trace_id, ctx.tracer._next_span_id(),
                           ctx.span_id, name, wall0, dur, tags)


def traced_iter(name: str, it: Iterable, **tags):
    """Wrap a generator so its full consumption (first ``next`` to
    exhaustion or abandonment) records one span; a no-op passthrough
    when untraced."""
    ctx = _CTX.get()
    if ctx is None:
        yield from it
        return
    wall0 = time.time()
    t0 = time.perf_counter()
    try:
        yield from it
    finally:
        record(ctx, name, wall0, time.perf_counter() - t0, **tags)


class Tracer:
    """Bounded in-memory span collector + slow-query log.

    The gateway owns one; instrumented layers never see it directly —
    they :func:`span` against whatever context the gateway opened.
    """

    def __init__(self, max_traces: int = 256, max_spans: int = 512,
                 slow_log_size: int = 32, slow_threshold_s: float = 0.25):
        self.max_traces = max_traces
        self.max_spans = max_spans
        self.slow_log_size = slow_log_size
        self.slow_threshold_s = slow_threshold_s
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self._slow: list[dict] = []
        self._span_seq = itertools.count(1)
        self.n_traces = 0
        self.n_spans = 0
        self.n_spans_dropped = 0

    # -- opening a trace ---------------------------------------------------
    def start(self, name: str, trace_id: Optional[str] = None,
              **tags) -> _Span:
        """Open (and register) a root span.  ``trace_id`` honors an
        incoming ``X-Trace-Id`` (sanitized); otherwise a fresh 16-hex-char
        id is minted.  Returns the root span context manager — its
        ``.trace_id`` goes back to the client."""
        if trace_id:
            trace_id = "".join(
                ch for ch in str(trace_id)[:64]
                if ch.isalnum() or ch in "-_") or None
        if not trace_id:
            trace_id = os.urandom(8).hex()
        with self._lock:
            if trace_id not in self._traces:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                self._traces[trace_id] = {"spans": [], "dropped": 0}
                self.n_traces += 1
        return _Span(_Ctx(self, trace_id, 0), name, tags)

    # -- recording (span machinery only) -----------------------------------
    def _next_span_id(self) -> int:
        return next(self._span_seq)

    def _record(self, trace_id: str, span_id: int, parent_id: int,
                name: str, wall0: float, dur: float, tags: dict) -> None:
        rec = {"span_id": span_id, "parent_id": parent_id, "name": name,
               "start": wall0, "dur_s": dur, "tags": dict(tags)}
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:      # evicted mid-flight; drop silently
                return
            if len(tr["spans"]) >= self.max_spans:
                tr["dropped"] += 1
                self.n_spans_dropped += 1
            else:
                tr["spans"].append(rec)
                self.n_spans += 1
            if parent_id == 0:      # root closed: slow-log check
                self._traces.move_to_end(trace_id)
                if dur >= self.slow_threshold_s:
                    self._note_slow_locked(
                        trace_id, name, wall0, dur, dict(tags),
                        self._tree_locked(trace_id))

    # -- slow-query log ----------------------------------------------------
    def _note_slow_locked(self, trace_id, name, wall0, dur, tags,
                          tree) -> None:
        entry = {"trace_id": trace_id, "name": name, "start": wall0,
                 "dur_s": dur, "tags": tags, "tree": tree}
        slow = self._slow
        if len(slow) < self.slow_log_size:
            slow.append(entry)
            return
        imin = min(range(len(slow)), key=lambda i: slow[i]["dur_s"])
        if dur > slow[imin]["dur_s"]:
            slow[imin] = entry
        # else: faster than everything retained — drop

    def note_slow(self, name: str, wall0: float, dur: float,
                  **tags) -> None:
        """Record an *untraced* request that crossed the threshold —
        tree-less (there were no spans), but present, so sampling can
        never hide a slow query entirely."""
        if dur < self.slow_threshold_s:
            return
        with self._lock:
            self._note_slow_locked(None, name, wall0, dur, tags, None)

    def slow(self) -> list[dict]:
        """Slowest-first snapshot of the slow-query log."""
        with self._lock:
            return sorted(self._slow, key=lambda e: -e["dur_s"])

    # -- reading -----------------------------------------------------------
    def _tree_locked(self, trace_id: str) -> Optional[dict]:
        tr = self._traces.get(trace_id)
        if tr is None:
            return None
        nodes = {}
        kids: dict = {}
        for rec in tr["spans"]:
            node = dict(rec)
            node["dur_ms"] = round(node.pop("dur_s") * 1e3, 3)
            node["children"] = []
            nodes[rec["span_id"]] = node
            kids.setdefault(rec["parent_id"], []).append(node)
        for sid, node in nodes.items():
            node["children"] = sorted(kids.get(sid, []),
                                      key=lambda n: n["start"])
        roots = sorted(kids.get(0, []), key=lambda n: n["start"])
        if not roots:       # trace registered but root still open
            return {"span_id": 0, "name": "(in flight)", "parent_id": None,
                    "children": [n for n in nodes.values()
                                 if n["parent_id"] not in nodes],
                    "dropped": tr["dropped"]}
        root = roots[0]
        # orphans (parent span dropped by the ring bound) hang off root
        for node in nodes.values():
            pid = node["parent_id"]
            if pid != 0 and pid not in nodes and node is not root:
                root["children"].append(node)
        root["dropped"] = tr["dropped"]
        return root

    def tree(self, trace_id: str) -> Optional[dict]:
        """The nested span tree for one trace id, or None if unknown
        (never collected, or LRU-evicted)."""
        with self._lock:
            return self._tree_locked(trace_id)

    def spans(self, trace_id: str) -> list[dict]:
        """Flat span records (tests assert parentage on these)."""
        with self._lock:
            tr = self._traces.get(trace_id)
            return [dict(r) for r in tr["spans"]] if tr else []

    def stats(self) -> dict:
        with self._lock:
            return {"n_traces": self.n_traces,
                    "live_traces": len(self._traces),
                    "n_spans": self.n_spans,
                    "n_spans_dropped": self.n_spans_dropped,
                    "slow_log": len(self._slow),
                    "slow_threshold_s": self.slow_threshold_s,
                    "max_traces": self.max_traces,
                    "max_spans": self.max_spans}

    def __repr__(self):
        return (f"Tracer(traces={self.n_traces}, spans={self.n_spans}, "
                f"slow={len(self._slow)})")
