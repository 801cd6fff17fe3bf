"""Time a request spends inside the gateway: the change over the window
of ``repro_http_request_seconds`` (sum over count, every route the mix
uses, job polls included), from ``obs.metrics.REGISTRY`` in the
gateway's process, in ms.  The gap to the client's latency is queueing
and transport.  Moves ``request_p95_ms``."""

NAME = "repro_http_request_seconds"


def _totals(snapshot: dict):
    s = c = 0.0
    for (name, labels), v in snapshot.items():
        route = dict(labels).get("route", "")
        if not route.startswith("/v1/") or route.startswith("/v1/trace"):
            continue
        if name == NAME + "_sum":
            s += v
        elif name == NAME + "_count":
            c += v
    return s, c


def read(run):
    if "before" not in run.layer:
        return None
    s0, c0 = _totals(run.layer["before"])
    s1, c1 = _totals(run.layer["after"])
    return 1e3 * (s1 - s0) / (c1 - c0) if c1 > c0 else None
