"""The gateway: threaded HTTP front door over one ``DBTable``.

Topology (arXiv:2309.02464's operational shape): one gateway process
binds a ``DB()`` backend — in-process memory, durable LSM, or a net
shard cluster — and serves many concurrent analyst requests while
ingest keeps flowing through the same backend's
:class:`~repro_torch.db.writer.WriterPool`.  The concurrency contract that
makes this work:

* every reader thread takes the binding's *read barrier*
  (``WriterPool.drain``) — a snapshot wait on the spill sequence, so a
  reader waits only for writes that preceded its request, never behind
  ingest still arriving (readers are not serialized behind the write
  barrier);
* hot bands are served from the shared per-backend
  :class:`~repro_torch.db.binding.ScanCache` (write-path invalidation keeps
  them coherent; many readers share one cache);
* request threads come from :class:`ThreadingHTTPServer` (one per
  connection, daemon) — long analytics are pushed to the bounded
  :class:`~repro_torch.serve.jobs.JobQueue` instead of pinning them.

Request pipeline: authenticate (401) → rate-limit at the route's cost
(429 + Retry-After) → dispatch; the degree guard surfaces as 413 and
write-rate admission refusals as 429 (see ``repro_torch.serve.routes``).

Run standalone::

    python -m repro_torch.serve --backend net --n-instances 4 \\
        --token s3cret:analytics:50 --port 8080

"""
from __future__ import annotations

import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from ..db.binding import AccidentalDenseError, DBTable
from ..db.writer import AsyncWriterError
from ..obs.metrics import REGISTRY
from ..obs.trace import Tracer
from .auth import AuthError, TokenAuth
from .coalesce import QueryCoalescer
from .jobs import JobQueue, QueueFull, UnknownJob
from .ratelimit import RateLimited, RateLimiter
from .routes import HTTPError, Request, match
from .stream import AlertPublisher, StatsPublisher

_PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# HTTP metric families, labeled by registered route *pattern* (bounded
# cardinality — "/v1/jobs/{id}", never the raw path) and status.  The
# gateway pins each child it uses in _http_children (families hold
# children weakly).
_M_HTTP = REGISTRY.counter(
    "repro_http_requests_total", "Gateway requests by route and status",
    labels=("route", "status"))
_M_HTTP_SECONDS = REGISTRY.histogram(
    "repro_http_request_seconds",
    "Gateway request wall time by route (SSE: setup only)",
    labels=("route",))


class Gateway:
    """Auth + rate limiting + routes + jobs + stream over one table."""

    def __init__(self, table: DBTable, auth: TokenAuth,
                 degree_limit: Optional[float] = None,
                 n_job_workers: int = 2, max_queued_jobs: int = 64,
                 job_result_ttl: float = 600.0,
                 stats_interval: float = 1.0,
                 coalesce_window: float = 0.003,
                 stream_analytics=None,
                 trace_sample: float = 0.0,
                 slow_threshold_s: float = 0.25):
        # the serving view always runs the densification guard: an
        # interactive endpoint must 413, never OOM the gateway
        if degree_limit is not None:
            table = table.with_degree_limit(degree_limit)
        self.table = table
        self.auth = auth
        self.limiter = RateLimiter()
        # request tracing: ?trace=1 / X-Trace-Id always trace; otherwise
        # trace_sample (probability, default 0.0) decides — the untraced
        # hot path costs one ContextVar read per instrumented site.  The
        # tracer doubles as the slow-query log (/v1/debug/slow).
        self.trace_sample = float(trace_sample)
        self.tracer = Tracer(slow_threshold_s=slow_threshold_s)
        self._http_children: dict = {}      # (route, status) pins
        self._http_lock = threading.Lock()
        self.jobs = JobQueue(n_workers=n_job_workers,
                             max_queued=max_queued_jobs,
                             result_ttl=job_result_ttl)
        # concurrent hot-path queries (topk, column scans) arriving
        # within this window evaluate as ONE eval_batch — a union
        # tablet scan + one device launch instead of N (<= 0 disables)
        self.coalescer = QueryCoalescer(window=coalesce_window)
        # a degree-table view sharing the main view's counters/cache,
        # so /v1/topk expresses as a *batchable* lazy TedgeDeg scan
        if self.table._is_degree:
            self.deg_table: Optional[DBTable] = self.table
        elif "TedgeDeg" in self.table.tables:
            dt = DBTable(self.table.backend, ("TedgeDeg",),
                         name=self.table.name,
                         cache_ttl=self.table.cache_ttl)
            dt.stats = self.table.stats
            self.deg_table = dt
        else:
            self.deg_table = None
        self.publisher = StatsPublisher(table, interval=stats_interval)
        # streaming temporal analytics (repro_torch.stream): rollup rides the
        # table's WriterPool ingest tap, alerts fan out over SSE
        self.stream_analytics = stream_analytics
        self.alert_publisher: Optional[AlertPublisher] = None
        if stream_analytics is not None:
            self.alert_publisher = AlertPublisher()
            stream_analytics.on_alert(self.alert_publisher.on_alert)
            if getattr(stream_analytics, "_table", None) is None:
                stream_analytics.attach(self.table)
            stream_analytics.start()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.address: Optional[str] = None

    # -- cluster-state admission (tenant-blind; see ratelimit.py) ----------
    def check_admission(self) -> None:
        if not self.table.admit_full_scan():
            cache = getattr(self.table.backend, "_scan_cache", None)
            window = cache.wps_window if cache is not None else 10.0
            raise HTTPError(
                429,
                f"full scan inadmissible: trailing write rate "
                f"{self.table.write_rate:.1f}/s exceeds the backend's "
                f"full-scan limit; retry when ingest slows",
                headers={"Retry-After": f"{window:g}"})

    # -- lifecycle ---------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Bind and serve in a background thread; returns ``host:port``
        (``port=0`` picks an ephemeral port)."""
        gw = self

        class Handler(_GatewayHandler):
            gateway = gw

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        # never join request threads on close: a live SSE stream would
        # stall shutdown until its client went away
        self._httpd.block_on_close = False
        self.address = f"{host}:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"gateway/{self.address}", daemon=True)
        self._thread.start()
        return self.address

    def stop(self) -> None:
        """Stop streaming, fail queued jobs fast, close the listener."""
        self.publisher.close()      # ends SSE generators first
        if self.alert_publisher is not None:
            self.alert_publisher.close()
        if self.stream_analytics is not None:
            self.stream_analytics.close()
        self.jobs.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- dispatch (called from request threads) ----------------------------
    def handle(self, req: Request, authorization: Optional[str],
               headers=None):
        """(status, payload, resp_headers) — payload is a dict, an SSE
        iterator, or a str (plain-text endpoints like /metrics).  Wraps
        :meth:`_handle` with the observability shell: per-request trace
        root (opt-in), HTTP counters/latency by route pattern, and the
        untraced slow-query note.  ``headers`` is the incoming header
        mapping (for ``X-Trace-Id``)."""
        if req.method == "GET" and req.path == "/metrics":
            # the scrape endpoint: unauthenticated, unmetered, untraced —
            # a Prometheus target can't carry tenant tokens
            return 200, REGISTRY.render(), {
                "Content-Type": _PROM_CONTENT_TYPE}
        incoming = headers.get("X-Trace-Id") if headers is not None else None
        traced = (req.params.get("trace") == "1" or bool(incoming)
                  or (self.trace_sample > 0.0
                      and random.random() < self.trace_sample))
        wall0 = time.time()
        t0 = time.perf_counter()
        status = 500
        root = None
        try:
            if traced:
                root = self.tracer.start(f"{req.method} {req.path}",
                                         trace_id=incoming,
                                         method=req.method, path=req.path)
                with root:
                    status, out, hdrs = self._handle(req, authorization)
                hdrs = dict(hdrs)
                hdrs["X-Trace-Id"] = root.trace_id
                return status, out, hdrs
            status, out, hdrs = self._handle(req, authorization)
            return status, out, hdrs
        except Exception as e:
            status = getattr(e, "status", 500)
            if root is not None:
                # best-effort: the error response still names its trace
                eh = getattr(e, "headers", None)
                if isinstance(eh, dict):
                    eh.setdefault("X-Trace-Id", root.trace_id)
            raise
        finally:
            dur = time.perf_counter() - t0
            pattern = getattr(req, "route_pattern", req.path)
            self._observe_http(pattern, status, dur)
            if not traced:
                # sampling must never hide a slow query entirely
                self.tracer.note_slow(f"{req.method} {req.path}", wall0,
                                      dur, route=pattern, status=status)

    def _observe_http(self, pattern: str, status: int, dur: float) -> None:
        key = (pattern, str(status))
        with self._http_lock:
            pair = self._http_children.get(key)
            if pair is None:
                pair = (_M_HTTP.labels(route=pattern, status=str(status)),
                        _M_HTTP_SECONDS.labels(route=pattern))
                self._http_children[key] = pair
        counter, hist = pair
        counter.inc()
        hist.observe(dur)

    def _handle(self, req: Request, authorization: Optional[str]):
        """The pre-obs dispatch: route match → auth → rate limit →
        handler, with all error mapping."""
        if req.method == "GET" and req.path == "/healthz":
            req.route_pattern = "/healthz"
            return 200, {"ok": True}, {}
        rt, args = match(req.method, req.path)
        if rt is None:
            raise HTTPError(404, f"no route for {req.method} {req.path}")
        req.route_pattern = rt.pattern      # bounded metric label
        req.tenant = self.auth.authenticate(authorization)
        try:
            self.limiter.acquire(req.tenant, rt.cost)
        except RateLimited as e:
            raise HTTPError(429, str(e),
                            headers={"Retry-After": f"{e.retry_after:.3f}"})
        try:
            out = rt.handler(self, req, **args)
        except AccidentalDenseError as e:
            # the degree guard: this column band would densify; the
            # query is refused, not the tenant — no Retry-After
            raise HTTPError(413, f"query refused by degree guard: {e}")
        except QueueFull as e:
            raise HTTPError(503, str(e), headers={"Retry-After": "5"})
        except UnknownJob as e:
            raise HTTPError(404, f"unknown job {e.args[0]!r}")
        except AsyncWriterError as e:
            raise HTTPError(500, f"backend writer failed: {e}")
        return 200, out, {}


class _GatewayHandler(BaseHTTPRequestHandler):
    gateway: Gateway = None         # bound by Gateway.start
    protocol_version = "HTTP/1.1"

    # -- plumbing ----------------------------------------------------------
    def log_message(self, fmt, *args):      # quiet; stats cover requests
        pass

    def _request(self) -> Request:
        parts = urlsplit(self.path)
        params = {k: v[0] for k, v in parse_qs(parts.query).items()}
        body = None
        if self.command == "POST":
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            if raw:
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError as e:
                    raise HTTPError(400, f"bad JSON body: {e}")
        return Request(self.command, parts.path, params, body=body)

    def _send_json(self, status: int, payload: dict,
                   headers: Optional[dict] = None) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _send_text(self, status: int, text: str,
                   headers: Optional[dict] = None) -> None:
        data = text.encode("utf-8")
        headers = dict(headers or {})
        ctype = headers.pop("Content-Type", "text/plain; charset=utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _send_sse(self, frames) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            for frame in frames:
                self.wfile.write(frame)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionError, OSError):
            pass                    # client went away mid-stream
        finally:
            self.close_connection = True

    def _dispatch(self) -> None:
        try:
            req = self._request()
            status, out, headers = self.gateway.handle(
                req, self.headers.get("Authorization"),
                headers=self.headers)
            if hasattr(out, "__next__"):        # SSE iterator
                self._send_sse(out)
                return
            if isinstance(out, str):            # plain text (/metrics)
                self._send_text(status, out, headers)
                return
            self._send_json(status, out, headers)
        except (HTTPError, AuthError, RateLimited) as e:
            status = getattr(e, "status", 500)
            headers = getattr(e, "headers", {})
            self._send_json(status, {"error": str(e), "status": status},
                            headers)
        except (BrokenPipeError, ConnectionError):
            pass
        except Exception as e:      # never kill the request thread silently
            try:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}",
                                      "status": 500})
            except OSError:
                pass

    def do_GET(self) -> None:
        self._dispatch()

    def do_POST(self) -> None:
        self._dispatch()


# ---------------------------------------------------------------------------
# Synthetic demo traffic + CLI.
# ---------------------------------------------------------------------------

def synthetic_incidence(seed: int = 0, duration: float = 60.0,
                        n_hosts: int = 128, n_bots: int = 8):
    """A small synthetic traffic capture as an incidence Assoc — the
    pipeline's generator, shared by the CLI's ``--demo-rows``, the
    gateway tests, and ``bench_serving``."""
    from ..core.schema import parse_tsv, val2col
    from ..pipeline import TrafficConfig
    from ..pipeline.pcap import records_to_tsv, synth_packets
    tcfg = TrafficConfig(n_hosts=n_hosts, pkt_rate=120.0, n_bots=n_bots,
                         beacon_period_s=5.0, beacon_jitter_s=0.1,
                         seed=seed)
    return val2col(parse_tsv(records_to_tsv(synth_packets(tcfg, duration))))


def main(argv=None) -> None:
    """``python -m repro_torch.serve`` — boot a gateway over a fresh or
    existing backend; prints ``LISTENING host:port`` once bound."""
    import argparse
    import signal

    from ..db import DB

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--backend", default="memory",
                   choices=("memory", "lsm", "net"))
    p.add_argument("--n-instances", type=int, default=1)
    p.add_argument("--path", default=None,
                   help="store directory (lsm, or durable net shards)")
    p.add_argument("--token", action="append", default=[],
                   metavar="TOKEN:TENANT[:RATE[:BURST]]",
                   help="register a tenant token (repeatable)")
    p.add_argument("--degree-limit", type=float, default=None)
    p.add_argument("--stats-interval", type=float, default=1.0)
    p.add_argument("--job-workers", type=int, default=2)
    p.add_argument("--coalesce-window", type=float, default=0.003,
                   help="seconds concurrent hot-path queries wait to "
                        "batch into one eval (0 disables)")
    p.add_argument("--trace-sample", type=float, default=0.0,
                   help="probability of tracing a request that didn't "
                        "ask (?trace=1 and X-Trace-Id always trace)")
    p.add_argument("--slow-threshold", type=float, default=0.25,
                   help="seconds above which a request enters the "
                        "slow-query log (/v1/debug/slow)")
    p.add_argument("--demo-rows", type=int, default=0,
                   help="ingest ~this many synthetic traffic edges at "
                        "boot (demo/smoke)")
    p.add_argument("--stream", action="store_true",
                   help="enable streaming temporal analytics: rollups "
                        "on the ingest tap, online detectors, "
                        "/v1/windows + /v1/alerts + SSE alert feed")
    args = p.parse_args(argv)
    if not args.token:
        p.error("at least one --token TOKEN:TENANT is required")

    T = DB("Tedge", "TedgeT", "TedgeDeg", backend=args.backend,
           n_instances=args.n_instances, path=args.path)
    sa = None
    if args.stream:
        from ..stream import StreamAnalytics
        # attach before any demo ingest so the rollup sees every block
        sa = StreamAnalytics().attach(T)
    if args.demo_rows:
        E = synthetic_incidence(duration=max(args.demo_rows / 480.0, 5.0))
        T.put(E, sync=False)
        T.flush()
    gw = Gateway(T, TokenAuth.from_specs(args.token),
                 degree_limit=args.degree_limit,
                 n_job_workers=args.job_workers,
                 stats_interval=args.stats_interval,
                 coalesce_window=args.coalesce_window,
                 stream_analytics=sa,
                 trace_sample=args.trace_sample,
                 slow_threshold_s=args.slow_threshold)
    addr = gw.start(host=args.host, port=args.port)
    print(f"LISTENING {addr}", flush=True)

    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    gw.stop()
    T.close()
    close = getattr(T.backend, "close", None)
    if close is not None:
        close()
