"""Tenant authentication for the serving gateway.

Bearer-token auth against a static tenant registry — the operational
model of a shared analytics cluster: operators mint one token per tenant
(an analyst team, a dashboard, an ingest monitor) and attach a rate
budget to it.  Stdlib only; tokens compare with
:func:`hmac.compare_digest` so lookup time never leaks prefix matches.

No token refresh or asymmetric signing here on purpose: the gateway sits
behind the cluster perimeter (same trust domain as the shard servers,
which speak an unauthenticated framed protocol); the token's job is
*tenancy attribution* for rate limiting and auditing, not cryptographic
identity.
"""
from __future__ import annotations

import dataclasses
import hmac
from typing import Dict, Iterable, Optional


class AuthError(Exception):
    """Missing/unknown credentials; the gateway maps this to HTTP 401."""
    status = 401


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One tenant's identity and budgets.

    ``rate``/``burst`` parameterize the tenant's token bucket
    (requests/s sustained, instantaneous burst); ``max_jobs`` bounds the
    tenant's concurrently *queued or running* background jobs.  Route
    costs are weighted, so ``rate=5`` sustains 5 cheap queries/s but
    fewer heavy scans (see ``repro_torch.serve.routes``).
    """
    name: str
    rate: float = 10.0
    burst: float = 20.0
    max_jobs: int = 4


class TokenAuth:
    """Static token → :class:`Tenant` registry.

    ``tokens`` maps each secret token to a :class:`Tenant` (or a bare
    tenant name, which gets default budgets).  ``authenticate`` accepts
    the ``Authorization`` header value — ``Bearer <token>`` or the raw
    token — and returns the tenant or raises :class:`AuthError`.
    """

    def __init__(self, tokens: Dict[str, "Tenant | str"]):
        self._tenants: Dict[str, Tenant] = {}
        for tok, tenant in tokens.items():
            if isinstance(tenant, str):
                tenant = Tenant(tenant)
            self._tenants[tok] = tenant

    def authenticate(self, authorization: Optional[str]) -> Tenant:
        if not authorization:
            raise AuthError("missing Authorization header")
        token = authorization.strip()
        if token.lower().startswith("bearer "):
            token = token[7:].strip()
        # constant-shape scan: compare against every registered token so
        # timing doesn't reveal whether a prefix matched
        found = None
        for known, tenant in self._tenants.items():
            if hmac.compare_digest(token, known):
                found = tenant
        if found is None:
            raise AuthError("unknown token")
        return found

    @property
    def tenants(self) -> Iterable[Tenant]:
        return list(self._tenants.values())

    @classmethod
    def from_specs(cls, specs: Iterable[str]) -> "TokenAuth":
        """Build from CLI specs ``token:tenant[:rate[:burst]]`` — e.g.
        ``--token s3cret:analytics:50:100``."""
        tokens: Dict[str, Tenant] = {}
        for spec in specs:
            parts = spec.split(":")
            if len(parts) < 2:
                raise ValueError(
                    f"bad token spec {spec!r}: want token:tenant[:rate[:burst]]")
            tok, name = parts[0], parts[1]
            rate = float(parts[2]) if len(parts) > 2 else 10.0
            burst = float(parts[3]) if len(parts) > 3 else max(2 * rate, 1.0)
            tokens[tok] = Tenant(name, rate=rate, burst=burst)
        return cls(tokens)
