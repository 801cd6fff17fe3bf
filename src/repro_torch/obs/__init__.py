"""repro_torch.obs — the observability plane (metrics registry + tracing).

Two stdlib-only modules with no package-internal imports, so every layer
(core, db, serve, stream, kernels) can instrument without cycles:

* :mod:`repro_torch.obs.metrics` — process-wide :data:`REGISTRY` of
  Counter/Gauge/Histogram families with weakly-held labeled children;
  rendered by the gateway's ``GET /metrics`` (Prometheus text format).
* :mod:`repro_torch.obs.trace` — contextvar-propagated request :func:`span`\\ s
  collected by a bounded :class:`Tracer` ring per gateway, with a
  slow-query log; O(ns) no-ops when no trace is active, and mirrored
  into a running ``torch.profiler`` (the module's span catalog).

See docs/api.md "Observability" for the metric catalog and tracing
semantics.
"""
from .metrics import (Counter, Gauge, Histogram, MetricFamily, Registry,
                      REGISTRY, obj_label)
from .trace import Tracer, current_ctx, record, span, traced_iter

__all__ = ["Counter", "Gauge", "Histogram", "MetricFamily", "Registry",
           "REGISTRY", "obj_label", "Tracer", "current_ctx", "record",
           "span", "traced_iter"]
