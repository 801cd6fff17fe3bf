"""The port's serving gateway (``repro_torch.serve``) against the JAX
package's, both bound to the same networked store: the port's shard
servers, which both packages' ``DB(backend="net", addresses=...)`` read.
Every endpoint must answer with the same status and the same JSON: keys,
strings and integers exactly, floats within rtol=1e-5, atol=1e-7 (the
device analytics are float32 in both, reduced in another order).  Also
the ``/metrics`` counters a request sequence leaves, the trace
round-trip, the error surface (400, 401, 404, 413, 429), the coalescer,
and the streaming routes over a net-backed table with the rollup tap.

Servers bind port 0 on loopback and stop in teardown; every HTTP request
carries its own timeout."""
import http.client
import json
import threading
import time

import numpy as np
import pytest

from repro import serve as jserve
from repro import stream as jstream
from repro.db import DB as JDB
from repro_torch import serve, stream
from repro_torch.core.expr import launch_counts
from repro_torch.db import DB, EdgeStore, ShardServer, put
from repro_torch.device import set_device
from repro_torch.serve.app import synthetic_incidence
from test_torch_netstore import IO, key_tree
from test_torch_stream import RTOL, T0, as_json, attack_cfg, same_json

HTTP_TIMEOUT = 20.0


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def tokens(pkg):
    return pkg.TokenAuth({
        "tok-a": pkg.Tenant("alice", rate=1000.0, burst=2000.0),
        "tok-b": pkg.Tenant("bob", rate=0.5, burst=2.0),
    })


def req(gw, method, path, token="tok-a", body=None, headers=None):
    host, port = gw.address.split(":")
    c = http.client.HTTPConnection(host, int(port), timeout=HTTP_TIMEOUT)
    hdrs = dict(headers or {})
    if token is not None:
        hdrs["Authorization"] = f"Bearer {token}"
    raw = json.dumps(body).encode() if body is not None else None
    if raw is not None:
        hdrs["Content-Type"] = "application/json"
    try:
        c.request(method, path, body=raw, headers=hdrs)
        r = c.getresponse()
        data = r.read()
        ctype = r.getheader("Content-Type") or ""
        out = json.loads(data) if data and "json" in ctype else \
            data.decode()
        return r.status, out, dict(r.getheaders())
    finally:
        c.close()


def wait_job(gw, jid, deadline=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline:
        s, d, _ = req(gw, "GET", f"/v1/jobs/{jid}")
        assert s == 200
        if d["status"] in ("done", "failed"):
            return d
        time.sleep(0.02)
    raise AssertionError(f"job {jid} never finished")


def job(gw, kind, params=None):
    s, d, _ = req(gw, "POST", "/v1/jobs",
                  body={"kind": kind, "params": params or {}})
    assert s == 200, d
    assert wait_job(gw, d["job"])["status"] == "done"
    s, out, _ = req(gw, "GET", f"/v1/jobs/{d['job']}/result")
    assert s == 200
    return out["result"]


def same_resid(T, prefix, fit, jfit):
    """Pop and compare a fit's ``resid``: log(degree) minus the fitted
    line, a float32 difference of terms up to log(max degree), so the
    two packages' residuals agree to RTOL of that scale, not of their
    own (near-zero) size."""
    r, jr = (np.asarray(f.pop("resid")) for f in (fit, jfit))
    scale = np.log(np.asarray(T.degree_assoc(prefix).triples()[2],
                              float).max())
    np.testing.assert_allclose(r, jr, rtol=RTOL, atol=RTOL * scale)


@pytest.fixture(scope="module")
def served():
    """One window in two port shard servers; a port gateway and a
    reference gateway, each over its own package's net binding to those
    servers (coalescing window 50 ms, so concurrent requests batch)."""
    prev = set_device("cpu")
    servers = [ShardServer(EdgeStore(n_tablets=2)).start()
               for _ in range(2)]
    addrs = [s.address for s in servers]
    T = DB("Tedge", "TedgeT", "TedgeDeg", backend="net", addresses=addrs,
           io_timeout=IO)
    put(T, synthetic_incidence(seed=3, duration=20.0, n_hosts=64,
                               n_bots=6))
    J = JDB("Tedge", "TedgeT", "TedgeDeg", backend="net", addresses=addrs)
    gws = {"port": serve.Gateway(T, tokens(serve), stats_interval=0.1,
                                 coalesce_window=0.05),
           "ref": jserve.Gateway(J, tokens(jserve), stats_interval=0.1,
                                 coalesce_window=0.05)}
    for g in gws.values():
        g.start()
    yield dict(gws, T=T, J=J, addrs=addrs)
    for g in gws.values():
        g.stop()
    for b in (T, J):
        b.close()
        b.backend.close()
    for s in servers:
        s.stop()
    set_device(prev)


PATHS = [
    "/v1/topk?prefix=ip.dst|&k=5",
    "/v1/topk?prefix=ip.src|&k=7",
    "/v1/topk?prefix=ip.dst|nowhere",
    "/v1/degree?prefix=ip.dst|",
    "/v1/degree?prefix=ip.src|&bins=8&resid=1",
    "/v1/degree?prefix=ip.dst|nowhere",
    "/v1/c2?top_k=5",
    "/v1/scanners?min_fanout=16",
    "/v1/scan?axis=row&start=000000000&stop=000000010",
    "/v1/scan?axis=row&keys=000000001,000000002,",
    "/v1/scan?axis=col&prefix=ip.dst|&max_cells=10",
    "/v1/scan?axis=col&keys=ip.proto|6,&max_cells=3",
    "/v1/topk?k=banana",
    "/v1/scan?axis=diag",
    "/v1/nope",
    "/v1/jobs/deadbeef",
    "/v1/windows",
    "/healthz",
]


class TestEndpoints:
    @pytest.mark.parametrize("path", PATHS)
    def test_endpoint_equals_reference(self, served, path):
        s, d, _ = req(served["port"], "GET", path)
        js, jd, _ = req(served["ref"], "GET", path)
        assert s == js
        if "resid=1" in path:
            same_resid(served["T"], "ip.src|", d["fit"], jd["fit"])
        same_json(d, jd)

    @pytest.mark.parametrize("kind,params", [
        ("pagerank", {"num_iters": 5, "top_k": 5}),
        ("degree_fit", {"prefix": "ip.src|"}),
        ("c2", {"top_k": 3}),
        ("scanners", {"min_fanout": 8}),
    ])
    def test_job_equals_reference(self, served, kind, params):
        got = job(served["port"], kind, params)
        want = job(served["ref"], kind, params)
        if kind == "degree_fit":
            same_resid(served["T"], params["prefix"], got["fit"],
                       want["fit"])
        same_json(got, want)

    def test_bad_job_kind(self, served):
        for g in ("port", "ref"):
            s, d, _ = req(served[g], "POST", "/v1/jobs",
                          body={"kind": "mine-bitcoin"})
            assert s == 400 and "unknown job kind" in d["error"]

    def test_stats_keys_and_kernel_launches(self, served):
        req(served["port"], "GET", "/v1/topk?k=2")
        s, d, _ = req(served["port"], "GET", "/v1/stats")
        js, jd, _ = req(served["ref"], "GET", "/v1/stats")
        assert s == js == 200
        drop = ("stream", "kernel_launches")    # sampled ticks; counters
        assert key_tree({k: v for k, v in d.items() if k not in drop}) == \
            key_tree({k: v for k, v in jd.items() if k not in drop})
        assert d["kernel_launches"] == launch_counts()
        assert set(d["kernel_launches"]) == set(jd["kernel_launches"])
        assert d["table"]["backend"]["kind"] == "NetMultiInstanceDB"

    def test_sse_stats_stream(self, served):
        for g in ("port", "ref"):
            host, port = served[g].address.split(":")
            c = http.client.HTTPConnection(host, int(port),
                                           timeout=HTTP_TIMEOUT)
            try:
                c.request("GET", "/v1/stream/stats?n=2",
                          headers={"Authorization": "Bearer tok-a"})
                r = c.getresponse()
                assert r.status == 200
                frames = [ln for ln in r.read().decode().splitlines()
                          if ln.startswith("data: ")]
            finally:
                c.close()
            assert len(frames) == 2
            assert {"rows_written_window", "queue_depth",
                    "writes_per_s"} <= set(json.loads(frames[0][6:]))


def http_counts(gw) -> dict:
    """``repro_http_requests_total`` samples from one ``/metrics`` scrape,
    by label set."""
    s, text, hdrs = req(gw, "GET", "/metrics", token=None)
    assert s == 200 and hdrs["Content-Type"].startswith("text/plain")
    out = {}
    for line in text.splitlines():
        if line.startswith("repro_http_requests_total{"):
            labels, value = line.rsplit(" ", 1)
            out[labels] = float(value)
    return out


class TestObservability:
    def test_metrics_counters_equal_reference(self, served):
        """The same request sequence moves the same HTTP counters."""
        seq = ["/v1/topk?k=3", "/v1/topk?k=banana", "/v1/nope",
               "/v1/scan?axis=col&prefix=ip.dst|&max_cells=2", "/healthz"]
        deltas = {}
        for g in ("port", "ref"):
            before = http_counts(served[g])
            for path in seq:
                req(served[g], "GET", path)
            req(served[g], "GET", "/v1/topk", token=None)
            after = http_counts(served[g])
            deltas[g] = {k: v - before.get(k, 0.0) for k, v in after.items()
                         if v != before.get(k, 0.0)}
        assert deltas["port"] == deltas["ref"]
        assert deltas["port"]

    def test_trace_round_trip(self, served):
        """``?trace=1`` returns an ``X-Trace-Id`` whose span tree the
        trace route serves; the two packages record the same spans."""
        names = {}
        for g in ("port", "ref"):
            s, _, hdrs = req(served[g], "GET", "/v1/c2?top_k=3&trace=1")
            assert s == 200
            tid = hdrs["X-Trace-Id"]
            s, d, _ = req(served[g], "GET", f"/v1/trace/{tid}")
            assert s == 200 and d["trace"] == tid
            seen = []

            def walk(node):
                seen.append(node["name"])
                for ch in node.get("children", []):
                    walk(ch)
            walk(d["tree"])
            names[g] = sorted(seen)
            assert names[g][0] and "GET /v1/c2" in names[g]
            assert req(served[g], "GET", "/v1/trace/feedface")[0] == 404
            s, d, _ = req(served[g], "GET", "/v1/debug/slow")
            assert s == 200 and "threshold_s" in d
        assert names["port"] == names["ref"]


class TestErrors:
    @pytest.mark.parametrize("token", [None, "wrong"])
    def test_401(self, served, token):
        got = req(served["port"], "GET", "/v1/topk", token=token)
        want = req(served["ref"], "GET", "/v1/topk", token=token)
        assert got[0] == want[0] == 401
        assert got[1] == want[1]

    def test_413_degree_guard(self, served):
        """A guarded view refuses a super-node column band with 413."""
        out = {}
        for g, pkg, mk in (("port", serve, DB), ("ref", jserve, JDB)):
            T = mk("Tedge", "TedgeT", "TedgeDeg", backend="net",
                   addresses=served["addrs"])
            gw = pkg.Gateway(T, tokens(pkg), degree_limit=3.0)
            gw.start()
            try:
                out[g] = req(gw, "GET", "/v1/scan?axis=col&prefix=ip.dst|")
            finally:
                gw.stop()
                T.close()
                T.backend.close()
        assert out["port"][0] == out["ref"][0] == 413
        assert "degree guard" in out["port"][1]["error"]
        assert out["port"][1] == out["ref"][1]

    def test_429_past_burst_sets_retry_after(self, served):
        for g in ("port", "ref"):
            codes = [req(served[g], "GET", "/v1/topk?k=1", token="tok-b")[0]
                     for _ in range(3)]
            assert codes[:2] == [200, 200] and codes[2] == 429
            s, d, hdrs = req(served[g], "GET", "/v1/topk", token="tok-b")
            assert s == 429 and float(hdrs["Retry-After"]) > 0
            assert "over budget" in d["error"]


class TestCoalescer:
    def test_concurrent_topk_batch(self, served):
        """8 concurrent top-k requests: 8 equal answers, equal to the
        reference's, and the coalescer saw a batch of 2 or more."""
        gw = served["port"]
        answers = []
        barrier = threading.Barrier(8)

        def one():
            barrier.wait(timeout=HTTP_TIMEOUT)
            answers.append(req(gw, "GET", "/v1/topk?prefix=ip.dst|&k=10"))

        threads = [threading.Thread(target=one) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * HTTP_TIMEOUT)
        assert len(answers) == 8
        assert all(a[0] == 200 and a[1] == answers[0][1] for a in answers)
        same_json(answers[0][1], req(served["ref"], "GET",
                                     "/v1/topk?prefix=ip.dst|&k=10")[1])
        s, d, _ = req(gw, "GET", "/v1/stats")
        assert d["coalesce"]["max_batch"] >= 2
        assert d["coalesce"]["n_batches"] >= 1

    @pytest.mark.parametrize("pkg", [serve, jserve], ids=["port", "ref"])
    def test_failing_member_gets_its_own_error(self, pkg):
        """A batch whose eval raises falls back member by member: each
        request gets its own result or error."""

        class Expr:
            def __init__(self, v):
                self.v = v

            def eval(self):
                if self.v < 0:
                    raise ValueError(f"bad member {self.v}")
                return self.v * 10

        co = pkg.QueryCoalescer(window=0.1)
        out = {}
        barrier = threading.Barrier(3)

        def one(v):
            barrier.wait(timeout=5)
            try:
                out[v] = co.eval(Expr(v))
            except ValueError as e:
                out[v] = str(e)

        threads = [threading.Thread(target=one, args=(v,))
                   for v in (1, -2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert out == {1: 10, -2: "bad member -2", 3: 30}
        assert co.stats()["n_batches"] == 1 and co.max_batch == 3


def stream_gateway(pkg, mk, backend, **db_kw):
    """The attack scenario streamed block by block into a table with the
    rollup tap; each block flushed before the detector step, so windows
    close in the same order in every run."""
    smod = stream if pkg is serve else jstream
    cfg = attack_cfg(smod)
    rec, truth = smod.synth_scenario(cfg)
    T = mk("Tedge", "TedgeT", "TedgeDeg", backend=backend, **db_kw)
    sa = smod.StreamAnalytics(interval=30.0)
    gw = pkg.Gateway(T, tokens(pkg), stats_interval=0.2,
                     stream_analytics=sa)
    gw.start()
    for _, A in smod.stream_blocks(cfg, rec=rec):
        T.put(A, sync=False)
        T.flush()
        sa.step()
    sa.step(force=True)
    return gw, T, truth, sa


@pytest.fixture(scope="module")
def streamed():
    prev = set_device("cpu")
    port = stream_gateway(serve, DB, "net", n_instances=2, io_timeout=IO)
    ref = stream_gateway(jserve, JDB, "memory")
    yield {"port": port, "ref": ref}
    for gw, T, _, _ in (port, ref):
        gw.stop()
        T.close()
        close = getattr(T.backend, "close", None)
        if close is not None:
            close()
    set_device(prev)


class TestStreaming:
    @pytest.mark.parametrize("path", [
        "/v1/windows?level=second&limit=500",
        "/v1/windows?level=minute",
        f"/v1/windows?level=second&since={T0 + 60.0}",
        "/v1/windows?level=fortnight",
        "/v1/alerts?limit=1000",
        "/v1/alerts?kind=ddos",
        "/v1/alerts?since=banana",
    ])
    def test_route_equals_reference(self, streamed, path):
        s, d, _ = req(streamed["port"][0], "GET", path)
        js, jd, _ = req(streamed["ref"][0], "GET", path)
        assert s == js
        same_json(d, jd)

    def test_rollup_conserves_and_every_attack_alerted(self, streamed):
        gw, T, truth, sa = streamed["port"]
        s, d, _ = req(gw, "GET", "/v1/windows?level=second&limit=10000")
        n_time = int(np.char.startswith(T[:, :].eval().triples()[1],
                                        "frame.time|").sum())
        assert sum(w["n_packets"] for w in d["windows"]) == n_time
        s, d, _ = req(gw, "GET", "/v1/alerts?limit=1000")
        for att in truth["attacks"]:
            assert [a for a in d["alerts"] if a["kind"] == att["kind"]
                    and a["window_start"] < att["stop"]
                    and a["window_stop"] > att["start"]], att["kind"]
        s, st, _ = req(gw, "GET", "/v1/stats")
        assert st["table"]["writers"]["n_taps"] == 1
        assert st["streaming"]["bank"]["n_alerts"] == d["n"]

    def test_root_cause_job_equals_direct_call(self, streamed):
        gw, _, truth, sa = streamed["port"]
        att = truth["attacks"][2]
        params = {"start": att["start"] - 1.0, "stop": att["stop"] + 1.0,
                  "seeds": [att["victim"]], "top_k": 3, "num_iters": 10}
        got = job(gw, "root_cause", params)["report"]
        want = sa.root_cause(params["start"], params["stop"],
                             seeds=params["seeds"], top_k=3, num_iters=10)
        same_json(got, as_json(want.to_dict()))
        assert any(h in att["attackers"] for h in got["hosts"])

    def test_sse_alert_replay(self, streamed):
        host, port = streamed["port"][0].address.split(":")
        c = http.client.HTTPConnection(host, int(port), timeout=HTTP_TIMEOUT)
        try:
            c.request("GET", "/v1/stream/alerts?replay=3&n=2",
                      headers={"Authorization": "Bearer tok-a"})
            r = c.getresponse()
            assert r.status == 200
            frames = [f for f in r.read().decode().split("\n\n")
                      if f.startswith("data: ")]
        finally:
            c.close()
        assert len(frames) == 2
        assert json.loads(frames[0][6:])["kind"] in ("spc", "c2", "scan",
                                                    "ddos")
