"""repro_torch.serve — the multi-tenant analytics serving gateway.

The front door over any ``DB()`` backend (memory | lsm | net):
authenticated JSON query endpoints, per-tenant token-bucket rate
limiting plus write-rate admission control, a bounded background job
queue for long analytics, and a live SSE stats stream.  Stdlib-only
(``http.server`` threads), matching the netstore's no-new-deps framing
style.  See docs/api.md "Serving gateway".
"""
from .app import Gateway, main, synthetic_incidence
from .auth import AuthError, Tenant, TokenAuth
from .coalesce import QueryCoalescer
from .jobs import JobQueue, QueueFull, UnknownJob
from .ratelimit import RateLimited, RateLimiter, TokenBucket
from .routes import HTTPError, Request, ROUTES
from .stream import AlertPublisher, EventPublisher, StatsPublisher

__all__ = ["Gateway", "main", "synthetic_incidence", "QueryCoalescer",
           "TokenAuth", "Tenant", "AuthError",
           "RateLimiter", "TokenBucket", "RateLimited",
           "JobQueue", "QueueFull", "UnknownJob",
           "EventPublisher", "StatsPublisher", "AlertPublisher",
           "HTTPError", "Request", "ROUTES"]
