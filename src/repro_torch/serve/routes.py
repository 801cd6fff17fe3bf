"""Route table: thin JSON endpoints over ``DBTable`` + ``LazyAssoc``.

Every handler is a pure function ``(gateway, request) -> payload`` —
the HTTP plumbing (auth, rate limiting, error mapping, serialization)
lives in ``repro_torch.serve.app``; the handlers only speak the D4M binding
and the analytics report types.  Each route declares a *cost* in
rate-limit tokens: a degree lookup is 1, a multi-band C2 sweep is 8 —
so a tenant's ``rate`` budget is spent proportionally to the tablet
work a request fans out.

Error surface (mapped by the app):

* bad/missing parameters → 400
* :class:`~repro_torch.db.binding.AccidentalDenseError` (the degree guard
  refusing a super-node column band) → **413 Payload Too Large** — the
  result *would* be too large, re-issue with a tighter selector;
* admission refusal (trailing write rate makes a full scan
  inadmissible) and rate-limit rejections → **429** + ``Retry-After``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..analytics import detect_c2, fit_degree_table, scan_report
from ..analytics.powerlaw import degree_histogram
from ..analytics.serialize import to_jsonable
from ..core import keys as K
from ..device import get_device


class HTTPError(Exception):
    def __init__(self, status: int, message: str,
                 headers: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.headers = headers or {}


@dataclasses.dataclass
class Request:
    method: str
    path: str
    params: Dict[str, str]
    tenant: object = None           # Tenant, set after auth
    body: Optional[dict] = None     # decoded JSON for POSTs


@dataclasses.dataclass(frozen=True)
class Route:
    handler: Callable
    cost: float = 1.0
    stream: bool = False            # SSE: handler returns an iterator
    pattern: str = ""               # the route's registered pattern —
                                    # the bounded-cardinality metric label


# (method, pattern) → Route; "{id}"-style segments match any one segment
ROUTES: Dict[Tuple[str, str], Route] = {}


def route(method: str, pattern: str, cost: float = 1.0,
          stream: bool = False):
    def deco(fn):
        ROUTES[(method, pattern)] = Route(fn, cost=cost, stream=stream,
                                          pattern=pattern)
        return fn
    return deco


def match(method: str, path: str):
    """(Route, path_args) for the first pattern whose segments match."""
    segs = [s for s in path.split("/") if s]
    for (m, pattern), rt in ROUTES.items():
        if m != method:
            continue
        psegs = [s for s in pattern.split("/") if s]
        if len(psegs) != len(segs):
            continue
        args = {}
        for p, s in zip(psegs, segs):
            if p.startswith("{") and p.endswith("}"):
                args[p[1:-1]] = s
            elif p != s:
                break
        else:
            return rt, args
    return None, {}


# -- parameter helpers -----------------------------------------------------

def _int(req: Request, name: str, default: int,
         lo: int = 1, hi: int = 1_000_000) -> int:
    raw = req.params.get(name)
    if raw is None:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise HTTPError(400, f"{name} must be an integer, got {raw!r}")
    if not lo <= v <= hi:
        raise HTTPError(400, f"{name} must be in [{lo}, {hi}]")
    return v


def _require(req: Request, name: str) -> str:
    v = req.params.get(name)
    if v is None:
        raise HTTPError(400, f"missing required parameter {name!r}")
    return v


# -- query endpoints (cheap, interactive) ----------------------------------

@route("GET", "/v1/topk", cost=1.0)
def topk(gw, req: Request) -> dict:
    """Top-K talkers straight from the combiner-maintained degree table
    (TedgeDeg) — never touches the edge tables.  Expressed as a lazy
    TedgeDeg scan through the gateway's coalescer: concurrent topk
    requests inside one window share a single batched eval."""
    prefix = req.params.get("prefix", "ip.dst|")
    k = _int(req, "k", 10, hi=10_000)
    if gw.deg_table is not None:
        deg = gw.coalescer.eval(gw.deg_table[K.StartsWith(prefix), :])
    else:
        deg = gw.table.degree_assoc(prefix)
    r, _, v = deg.triples()
    v = np.asarray(v, np.float64)
    order = np.argsort(v)[::-1][:k]
    return {"prefix": prefix, "k": k,
            "hosts": [{"key": str(r[i]), "degree": float(v[i])}
                      for i in order]}


@route("GET", "/v1/degree", cost=2.0)
def degree_fit(gw, req: Request) -> dict:
    """Degree distribution: log-binned histogram + rank-size power-law
    fit over the TedgeDeg band under ``prefix``; both run on the
    port's device."""
    prefix = req.params.get("prefix", "ip.dst|")
    bins = _int(req, "bins", 32, hi=512)
    deg = gw.table.degree_assoc(prefix)
    if deg.nnz == 0:
        return {"prefix": prefix, "n": 0, "fit": None, "histogram": None}
    d = torch.as_tensor(np.asarray(deg.triples()[2], np.float32),
                        dtype=torch.float32, device=get_device())
    fit = fit_degree_table(gw.table, prefix).to_dict()
    if not req.params.get("resid"):
        fit.pop("resid")            # O(n) payload, opt-in only
    centers, counts = degree_histogram(d, n_bins=bins)
    return {"prefix": prefix, "n": int(deg.nnz), "fit": fit,
            "histogram": {"centers": to_jsonable(centers),
                          "counts": to_jsonable(counts)}}


@route("GET", "/v1/c2", cost=8.0)
def c2(gw, req: Request) -> dict:
    """Fused C2 detector over the live table (four pushed-down column-
    band scans + device scoring)."""
    top_k = _int(req, "top_k", 10, hi=1000)
    rep = detect_c2(gw.table, sep=req.params.get("sep", "|"), top_k=top_k)
    return {"top_k": top_k, "report": rep.to_dict()}


@route("GET", "/v1/scanners", cost=8.0)
def scanners(gw, req: Request) -> dict:
    min_fanout = _int(req, "min_fanout", 32, hi=1_000_000)
    rep = scan_report(gw.table, sep=req.params.get("sep", "|"),
                      min_fanout=min_fanout)
    return {"report": rep.to_dict()}


# -- admission-limited scans -----------------------------------------------

def _selector(req: Request):
    """One of keys= / prefix= / start=&stop= — or None for a full axis."""
    if "keys" in req.params:
        return req.params["keys"]               # 'a,b,c,' grammar
    if "prefix" in req.params:
        return K.StartsWith(req.params["prefix"])
    if "start" in req.params or "stop" in req.params:
        return K.KeyRange(_require(req, "start"), _require(req, "stop"))
    return None


@route("GET", "/v1/scan", cost=4.0)
def scan(gw, req: Request) -> dict:
    """Subrange / prefix scan returning raw triples.

    ``axis=row`` scans Tedge, ``axis=col`` the transpose table (and
    runs the accidental-densification guard → 413).  With no selector
    the scan is full-table and subject to write-rate admission → 429.
    ``max_cells`` truncates the payload (default 10 000) — ``truncated``
    says whether more existed.

    Evaluation goes through the gateway's coalescer: concurrent scans
    arriving within one window batch into a single union tablet scan
    (``eval_batch``) — 8 concurrent column readers cost one scan.
    """
    axis = req.params.get("axis", "row")
    if axis not in ("row", "col"):
        raise HTTPError(400, f"axis must be 'row' or 'col', got {axis!r}")
    sel = _selector(req)
    max_cells = _int(req, "max_cells", 10_000, hi=1_000_000)
    if sel is None:
        gw.check_admission()        # full-table work needs admission
        lazy = gw.table[:, :]
    elif axis == "row":
        lazy = gw.table[sel, :]
    else:
        lazy = gw.table[:, sel]
    A = gw.coalescer.eval(lazy)
    r, c, v = A.triples()
    n = int(r.shape[0])
    cut = min(n, max_cells)
    return {"axis": axis, "nnz": n, "truncated": n > cut,
            "triples": [[str(r[i]), str(c[i]), str(v[i])]
                        for i in range(cut)]}


# -- async jobs ------------------------------------------------------------

def _job_fns(gw, params: dict) -> Dict[str, Callable[[], dict]]:
    """Job kinds → zero-arg closures returning JSON-serializable dicts.
    Long analytics only — cheap queries belong on the request path."""

    def pagerank() -> dict:
        from ..analytics.distributed import pagerank_table
        n_top = int(params.get("top_k", 20))
        keys, ranks = pagerank_table(
            gw.table, num_iters=int(params.get("num_iters", 20)))
        ranks = ranks.cpu().numpy()
        order = np.argsort(ranks)[::-1][:n_top]
        return {"nodes": [{"key": str(keys[i]), "rank": float(ranks[i])}
                          for i in order],
                "n_nodes": int(ranks.shape[0])}

    def degree_fit_full() -> dict:
        fit = fit_degree_table(gw.table, params.get("prefix", "ip.dst|"))
        return {"fit": fit.to_dict()}

    def c2_sweep() -> dict:
        rep = detect_c2(gw.table, top_k=int(params.get("top_k", 10)))
        return {"report": rep.to_dict()}

    def scan_sweep() -> dict:
        rep = scan_report(gw.table,
                          min_fanout=int(params.get("min_fanout", 32)))
        return {"report": rep.to_dict()}

    def root_cause_job() -> dict:
        sa = _stream_analytics(gw)
        try:
            start = float(params["start"])
            stop = float(params["stop"])
        except (KeyError, ValueError):
            raise HTTPError(400, "root_cause needs numeric "
                                 "params.start and params.stop")
        seeds = params.get("seeds")
        rep = sa.root_cause(start, stop, seeds=seeds,
                            top_k=int(params.get("top_k", 5)),
                            num_iters=int(params.get("num_iters", 30)))
        return {"report": rep.to_dict()}

    return {"pagerank": pagerank, "degree_fit": degree_fit_full,
            "c2": c2_sweep, "scanners": scan_sweep,
            "root_cause": root_cause_job}


@route("POST", "/v1/jobs", cost=2.0)
def submit_job(gw, req: Request) -> dict:
    """Enqueue a long analytic.  Identical (kind, params) submissions
    arriving while a matching job is still queued coalesce onto one
    execution per queue drain — each caller keeps its own job id."""
    import json
    body = req.body or {}
    kind = body.get("kind")
    params = body.get("params") or {}
    fns = _job_fns(gw, params)
    if kind not in fns:
        raise HTTPError(400, f"unknown job kind {kind!r}; "
                             f"one of {sorted(fns)}")
    bkey = json.dumps({"kind": kind, "params": params}, sort_keys=True)
    job = gw.jobs.submit(kind, fns[kind], req.tenant, batch_key=bkey)
    return job.describe()


@route("GET", "/v1/jobs/{id}", cost=0.1)
def job_status(gw, req: Request, id: str) -> dict:
    return gw.jobs.get(id).describe()


@route("GET", "/v1/jobs/{id}/result", cost=0.5)
def job_result(gw, req: Request, id: str) -> dict:
    job = gw.jobs.get(id)
    if job.status in ("queued", "running"):
        # 202: accepted, not ready — poll the status endpoint
        raise HTTPError(202, f"job {id} is {job.status}")
    if job.status == "failed":
        raise HTTPError(500, f"job {id} failed: {job.error}")
    return {"job": job.id, "kind": job.kind, "result": job.result}


# -- streaming temporal analytics (repro_torch.stream) ------------------------

def _stream_analytics(gw):
    sa = getattr(gw, "stream_analytics", None)
    if sa is None:
        raise HTTPError(404, "streaming analytics not enabled on this "
                             "gateway (boot with --stream)")
    return sa


@route("GET", "/v1/windows", cost=0.5)
def windows(gw, req: Request) -> dict:
    """Closed rollup-window summaries for one level, oldest first.
    ``level`` is second|minute|hour; ``since`` filters on window start
    (epoch seconds); summaries are the rollup's WindowSummary reports
    (counts, unique src/dst, top destination, power-law fit)."""
    sa = _stream_analytics(gw)
    level = req.params.get("level", "second")
    if level not in dict(sa.rollup.levels):
        raise HTTPError(400, f"unknown level {level!r}; one of "
                             f"{sorted(dict(sa.rollup.levels))}")
    since = req.params.get("since")
    try:
        since_f = float(since) if since is not None else None
    except ValueError:
        raise HTTPError(400, f"since must be a number, got {since!r}")
    items = sa.rollup.summaries(
        level=level, limit=_int(req, "limit", 100, hi=10_000),
        since=since_f)
    return {"level": level, "n": len(items),
            "windows": [w.to_dict() for w in items]}


@route("GET", "/v1/alerts", cost=0.5)
def alerts(gw, req: Request) -> dict:
    """Recent detector alerts, oldest first.  ``kind`` filters to one
    of spc|c2|scan|ddos; ``since`` on window start."""
    sa = _stream_analytics(gw)
    since = req.params.get("since")
    try:
        since_f = float(since) if since is not None else None
    except ValueError:
        raise HTTPError(400, f"since must be a number, got {since!r}")
    items = sa.bank.alerts(limit=_int(req, "limit", 100, hi=10_000),
                           kind=req.params.get("kind"), since=since_f)
    return {"n": len(items), "alerts": [a.to_dict() for a in items]}


@route("GET", "/v1/stream/alerts", cost=1.0, stream=True)
def stream_alerts(gw, req: Request):
    """SSE live feed of detector alerts (one ``data: <json>`` frame per
    AlertReport).  ``n`` bounds the number of events; ``replay`` resends
    that many recent alerts first."""
    _stream_analytics(gw)
    n = req.params.get("n")
    return gw.alert_publisher.events(
        max_events=int(n) if n is not None else None,
        replay=_int(req, "replay", 0, lo=0, hi=10_000))


# -- observability ---------------------------------------------------------

@route("GET", "/v1/stats", cost=0.1)
def stats(gw, req: Request) -> dict:
    """The unified counter snapshot: table (routes/cache/writers/backend)
    + rate limiter + job queue + the stream's latest windowed sample."""
    from ..core.expr import launch_counts
    sa = getattr(gw, "stream_analytics", None)
    return {"table": to_jsonable(gw.table.stats()),
            "ratelimit": gw.limiter.stats(),
            "jobs": gw.jobs.stats(),
            "coalesce": gw.coalescer.stats(),
            "kernel_launches": launch_counts(),
            "trace": gw.tracer.stats(),
            "stream": gw.publisher.latest(),
            "streaming": to_jsonable(sa.stats()) if sa is not None
            else None}


@route("GET", "/v1/trace/{id}", cost=0.1)
def trace_tree(gw, req: Request, id: str) -> dict:
    """The span tree one traced request left behind: request with
    ``?trace=1`` (or an ``X-Trace-Id`` header), read the ``X-Trace-Id``
    response header, fetch it here.  404 once the trace ages out of the
    tracer's bounded ring."""
    tree = gw.tracer.tree(id)
    if tree is None:
        raise HTTPError(404, f"unknown trace {id!r} (never sampled, or "
                             f"evicted from the ring)")
    return {"trace": id, "tree": tree}


@route("GET", "/v1/debug/slow", cost=0.1)
def slow_log(gw, req: Request) -> dict:
    """The slow-query log: the N slowest requests over the tracer's
    threshold, slowest first — traced entries carry their full span
    tree, untraced ones are tree-less but still present."""
    return {"threshold_s": gw.tracer.slow_threshold_s,
            "slow": gw.tracer.slow()}


@route("GET", "/v1/stream/stats", cost=1.0, stream=True)
def stream_stats(gw, req: Request):
    """SSE live stream of windowed ingest/query counters.  ``n`` bounds
    the number of events (handy for curl/tests); ``replay`` resends that
    many recent samples first."""
    n = req.params.get("n")
    return gw.publisher.events(
        max_events=int(n) if n is not None else None,
        replay=_int(req, "replay", 0, lo=0, hi=10_000))
