"""Per-tenant token buckets and scan admission control.

Two distinct "no" signals, deliberately kept separate:

* **rate limiting** (:class:`RateLimiter`) — *per-tenant* budget
  enforcement.  Each tenant gets a token bucket sized by its
  :class:`~repro_torch.serve.auth.Tenant` ``rate``/``burst``; route costs are
  weighted (a C2 sweep debits more than a degree lookup).  Exceeding the
  budget raises :class:`RateLimited` → HTTP 429 with ``Retry-After`` set
  to when the bucket next covers the request.  One tenant's rejections
  never touch another tenant's bucket — the isolation property
  ``tests/test_gateway.py`` asserts under concurrent load.

* **admission control** — *cluster-state* backpressure, tenant-blind.
  Full-table work is refused while the trailing write rate exceeds the
  scan cache's ``full_scan_wps_limit``
  (:meth:`repro_torch.db.binding.DBTable.admit_full_scan`): the scan would be
  stale before finishing and its cache entry evicted by the next write.
  Also 429, with a ``Retry-After`` of the cache's sampling window.

Buckets are continuous-refill (no background timer thread): each
``acquire`` settles elapsed time into the balance under the bucket lock.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

from ..obs.metrics import REGISTRY as _REGISTRY, obj_label as _obj_label
from .auth import Tenant

_M_ALLOWED = _REGISTRY.counter(
    "repro_ratelimit_allowed_total", "Requests admitted by token buckets",
    labels=("limiter",))
_M_REJECTED = _REGISTRY.counter(
    "repro_ratelimit_rejected_total",
    "Requests rejected over budget (HTTP 429)", labels=("limiter",))


class RateLimited(Exception):
    """Budget exceeded; the gateway maps this to 429 + Retry-After."""
    status = 429

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = retry_after


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` cap."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = max(rate, 1e-9)
        self.burst = max(burst, 1e-9)
        self.clock = clock
        self._tokens = self.burst
        self._stamp = clock()
        self._lock = threading.Lock()

    def try_acquire(self, cost: float = 1.0) -> float:
        """Debit ``cost`` tokens.  Returns 0.0 on success, else the
        seconds until the bucket will cover the request (the caller's
        ``Retry-After``).  A cost above ``burst`` can never succeed —
        reported as the time to fill the whole bucket."""
        now = self.clock()
        with self._lock:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= cost:
                self._tokens -= cost
                return 0.0
            return (min(cost, self.burst) - self._tokens) / self.rate

    @property
    def tokens(self) -> float:
        with self._lock:
            now = self.clock()
            return min(self.burst,
                       self._tokens + (now - self._stamp) * self.rate)


class RateLimiter:
    """One bucket per tenant, created lazily from the tenant's budgets."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self.metrics_label = _obj_label("limiter")
        self._m_allowed = _M_ALLOWED.labels(limiter=self.metrics_label)
        self._m_rejected = _M_REJECTED.labels(limiter=self.metrics_label)

    # registry-backed counter reads (compat: pre-obs attribute shapes)
    @property
    def n_allowed(self) -> int:
        return self._m_allowed.value

    @property
    def n_rejected(self) -> int:
        return self._m_rejected.value

    def _bucket(self, tenant: Tenant) -> TokenBucket:
        b = self._buckets.get(tenant.name)
        if b is None:
            with self._lock:
                b = self._buckets.get(tenant.name)
                if b is None:
                    b = TokenBucket(tenant.rate, tenant.burst,
                                    clock=self.clock)
                    self._buckets[tenant.name] = b
        return b

    def acquire(self, tenant: Tenant, cost: float = 1.0) -> None:
        retry = self._bucket(tenant).try_acquire(cost)
        if retry > 0.0:
            self._m_rejected.inc()
            raise RateLimited(
                f"tenant {tenant.name!r} over budget "
                f"(rate={tenant.rate:g}/s, cost={cost:g})", retry)
        self._m_allowed.inc()

    def stats(self) -> dict:
        return {"n_allowed": self.n_allowed, "n_rejected": self.n_rejected,
                "tenants": sorted(self._buckets)}
