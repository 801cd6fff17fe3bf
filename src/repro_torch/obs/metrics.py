"""Process-wide metrics registry — the unified counter plane.

Before this module, every layer grew its own ad-hoc counters: the
:class:`~repro_torch.db.binding.ScanCache` kept plain-int hits/misses, the
:class:`~repro_torch.db.writer.WriterPool` summed per-writer fields outside
any lock, ``ShardClient.n_rpcs`` was incremented from concurrent reader
threads without a lock, and ``core.expr`` mutated a bare module dict per
kernel launch.  Each was individually small; together they made "where
does this deployment spend its time" unanswerable without poking five
objects — and two of them were genuine data races.

This registry absorbs them behind three primitives:

* :class:`Counter` — a lock-guarded monotonic count.  The lock is
  uncontended in the common case (one ``inc`` is ~100 ns), which is what
  "lock-cheap" means here: cheap enough for per-block / per-RPC paths,
  not for per-cell loops (batch those with ``inc(n)``).
* :class:`Gauge` — a settable level, or a live callback
  (:meth:`Gauge.set_function`) so queue depths and backlogs are read at
  scrape time from the owning object instead of being double-maintained.
* :class:`Histogram` — fixed log2 latency buckets (1 µs · 2^i), rendered
  as cumulative Prometheus buckets.

Metrics are grouped into **families** (one name + label schema), and a
family hands out **labeled children** (:meth:`MetricFamily.labels`).
Children are held *weakly*: the owning object (a cache, a writer pool, a
shard client) keeps the only strong reference, so when it is collected
its samples leave ``/metrics`` with it — per-object label cardinality is
bounded by *live* objects, not by every object ever created (test suites
create thousands).  Callers must therefore retain the child they get
back from ``labels()``.

Compatibility contract: objects that migrated their counters here keep
their public attribute shapes (``cache.hits``, ``pool.n_written``,
``client.n_rpcs`` …) as properties reading the same child — so
``T.stats()`` / ``/v1/stats`` payloads are unchanged, and ``/metrics``
reports *identical* values by construction (one underlying count, two
read surfaces; locked by tests/test_obs.py).
"""
from __future__ import annotations

import itertools
import threading
import weakref
from typing import Callable, Dict, Iterable, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricFamily", "Registry",
           "REGISTRY", "obj_label"]

_OBJ_SEQ = itertools.count()


def obj_label(prefix: str) -> str:
    """A process-unique label value for per-object metric children
    (``cache-3``, ``pool-17`` …) — objects that can exist many times per
    process label their children with this so each one's counts stay
    exact (and its compat properties read back only its own)."""
    return f"{prefix}-{next(_OBJ_SEQ)}"


class Counter:
    """Monotonic count; ``inc`` is atomic under an uncontended lock."""

    __slots__ = ("__weakref__", "_lock", "_value")
    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def samples(self) -> Iterable[tuple]:
        yield "", (), self._value

    def __repr__(self):
        return f"Counter({self._value})"


class Gauge:
    """A level: ``set``/``inc``/``dec``, or a live read via
    :meth:`set_function` (evaluated at scrape — use a weakref-closing
    callback so the gauge never pins its owner)."""

    __slots__ = ("__weakref__", "_lock", "_value", "_fn")
    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        self.inc(-n)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self):
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:       # a dying owner must not break scrape
                return 0.0
        return self._value

    def samples(self) -> Iterable[tuple]:
        yield "", (), self.value

    def __repr__(self):
        return f"Gauge({self.value})"


class Histogram:
    """Fixed log2 buckets: upper bounds ``base * 2**i``.  The default
    (1 µs … ~67 s) covers everything from a cache hit to a stuck full
    scan; ``observe`` is O(log buckets) via binary search."""

    __slots__ = ("__weakref__", "_lock", "bounds", "_counts",
                 "_sum", "_count")
    kind = "histogram"

    def __init__(self, base: float = 1e-6, n_buckets: int = 26):
        self.bounds = tuple(base * (1 << i) for i in range(n_buckets))
        self._lock = threading.Lock()
        self._counts = [0] * n_buckets
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            if lo < len(self._counts):
                self._counts[lo] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def samples(self) -> Iterable[tuple]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum = 0
        for bound, n in zip(self.bounds, counts):
            cum += n
            yield "_bucket", (("le", f"{bound:.9g}"),), cum
        yield "_bucket", (("le", "+Inf"),), total
        yield "_sum", (), s
        yield "_count", (), total

    def __repr__(self):
        return f"Histogram(count={self._count}, sum={self._sum:g})"


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One metric name + label schema, fanning out to labeled children.

    Children are weakly held (see module docstring); the zero-label
    child (``labels()`` with no schema) is pinned on the family so
    module-level metrics never vanish.
    """

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: Tuple[str, ...] = (), **child_kw):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._child_kw = child_kw
        self._lock = threading.Lock()
        self._children: "weakref.WeakValueDictionary" = \
            weakref.WeakValueDictionary()
        self._default = None        # pin for the unlabeled child

    def labels(self, **kw):
        """The child for one label-value combination, created on first
        use.  Keep the returned object alive — the family only holds it
        weakly."""
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got {tuple(kw)}")
        key = tuple(str(kw[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind](**self._child_kw)
                self._children[key] = child
                if not key:
                    self._default = child
            return child

    def collect(self):
        """Snapshot of ``(labelvalues, child)`` pairs, stable-ordered."""
        with self._lock:
            return sorted(self._children.items())


class Registry:
    """Named metric families + the Prometheus text renderer.

    ``counter``/``gauge``/``histogram`` are get-or-create and idempotent
    (same name must mean same kind + label schema), so modules can
    declare their families at import time without registration order
    mattering.  With no ``labels`` schema the (pinned) unlabeled child
    is returned directly — the common case for module-level metrics.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _family(self, name: str, kind: str, help: str,
                labels: Tuple[str, ...], **child_kw) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(name, kind, help, labels, **child_kw)
                self._families[name] = fam
            elif fam.kind != kind or fam.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-registered with a different "
                    f"kind/label schema")
            return fam

    def counter(self, name: str, help: str = "", labels=()):
        fam = self._family(name, "counter", help, tuple(labels))
        return fam if labels else fam.labels()

    def gauge(self, name: str, help: str = "", labels=()):
        fam = self._family(name, "gauge", help, tuple(labels))
        return fam if labels else fam.labels()

    def histogram(self, name: str, help: str = "", labels=(), **kw):
        fam = self._family(name, "histogram", help, tuple(labels), **kw)
        return fam if labels else fam.labels()

    # -- scrape surface ----------------------------------------------------
    @staticmethod
    def _esc(v: str) -> str:
        return v.replace("\\", r"\\").replace('"', r'\"') \
                .replace("\n", r"\n")

    def render(self) -> str:
        """The Prometheus text exposition (``GET /metrics``)."""
        lines = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            children = fam.collect()
            if not children:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labelvalues, child in children:
                base = list(zip(fam.labelnames, labelvalues))
                for suffix, extra, value in child.samples():
                    pairs = base + list(extra)
                    label_s = ",".join(
                        f'{k}="{self._esc(v)}"' for k, v in pairs)
                    label_s = "{" + label_s + "}" if label_s else ""
                    v = f"{value:.9g}" if isinstance(value, float) \
                        else str(value)
                    lines.append(f"{fam.name}{suffix}{label_s} {v}")
        return "\n".join(lines) + "\n"

    def as_dict(self) -> Dict[tuple, float]:
        """``{(name+suffix, ((label, value), ...)): sample}`` — the
        test-friendly view the /metrics↔stats identity assertions use."""
        out = {}
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            for labelvalues, child in fam.collect():
                base = tuple(zip(fam.labelnames, labelvalues))
                for suffix, extra, value in child.samples():
                    out[(fam.name + suffix, base + tuple(extra))] = value
        return out


#: The process-wide default registry every layer registers into (and the
#: gateway's ``GET /metrics`` renders).
REGISTRY = Registry()
