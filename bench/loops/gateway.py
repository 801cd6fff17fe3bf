"""Independent analysts over HTTP: the gateway over the networked shard
store, offered an open loop of requests.

Set-up makes the window's packets from the seed, hands the program their
TSV, ingests it through ``DB(..., backend="net")`` (local shard servers)
and flushes, then starts ``repro_torch.serve.Gateway`` on a local port
with the workload's coalesce window, job workers and a token whose rate
limit is above the offered load, and sends every route of the mix once
(and one burst) as warm-up.  The window is a schedule from
:mod:`bench.traffic.mix`, sent by a client in a process of its own
(``bench/harness/client.py``) at the due times whatever the answers.
Each request's latency runs from its due time to its answer (a job's:
from its due time to its result); one that failed or was refused counts
as infinite.  Once every answer is in, each is compared with the
reference's.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

from bench.harness.common import BENCH, Check, Run, percentile
from bench.harness.spans import host_intervals
from bench.reference import compare as C
from bench.reference.d4m import Window, degree_histogram, fit_rank_size
from bench.traffic import frozen_window, mix, ranked_hosts

TOKEN = "bench-analyst"
CHECKS = ("topk_gap", "scan_mismatch", "degree_rel", "c2_rel",
          "pagerank_rel")


class Served:
    """The program under test: the gateway over the net store, set up
    over one window."""

    def __init__(self, cfg: dict, wl: dict, seed: int):
        from repro_torch.core.schema import parse_tsv, val2col
        from repro_torch.db import DB, put
        from repro_torch.serve import Gateway, TokenAuth
        self.rec, tsv = frozen_window(cfg, seed)
        E = val2col(parse_tsv(tsv))
        del tsv
        store = cfg["store"]
        self.T = DB("Tedge", "TedgeT", "TedgeDeg", backend=store["backend"],
                    n_instances=store["n_instances"],
                    tablets_per_instance=store["tablets_per_instance"],
                    cache_ttl=store["scan_cache_ttl_s"])
        put(self.T, E.putval("1,"))
        self.T.flush()
        del E
        g = wl["gateway"]
        self.gw = Gateway(
            self.T, TokenAuth.from_specs(
                [f"{TOKEN}:analysts:{g['token_rate']}:{g['token_burst']}"]),
            n_job_workers=int(g["job_workers"]),
            coalesce_window=float(g["coalesce_window_s"]))
        self.address = self.gw.start()

    def close(self) -> None:
        self.gw.stop()
        self.T.close()
        close = getattr(self.T.backend, "close", None)
        if close is not None:
            close()


def send(address: str, reqs: list, trace: bool, workers: int = 64,
         grace_s: float = 60.0) -> list:
    """Run the client process over ``reqs``; its answers, in order."""
    spec = {"address": address, "token": TOKEN, "workers": workers,
            "trace": trace, "grace_s": grace_s, "poll_s": 0.01,
            "requests": [{k: r[k] for k in ("due", "method", "path", "body",
                                            "job") if k in r}
                         for r in reqs]}
    proc = subprocess.run([sys.executable, str(BENCH / "harness" /
                                               "client.py")],
                          input=json.dumps(spec), capture_output=True,
                          text=True, timeout=reqs[-1]["due"] + grace_s + 60
                          if reqs else 120)
    if proc.returncode != 0:
        raise RuntimeError(f"client failed: {proc.stderr[-2000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()]


def setup(cfg: dict, wl: dict, seed: int, sync):
    """(the served program, ranked destinations, their packet counts,
    set-up seconds): ingest, the gateway, and the warm-up requests."""
    t_setup = time.perf_counter()
    prog = Served(cfg, wl, seed)
    hosts, counts = ranked_hosts(prog.rec)
    one, burst = mix.warmup(wl, hosts)
    for r in one:
        send(prog.address, [r], False)
    if burst:
        send(prog.address, burst, False)
    sync()
    return prog, hosts, counts, time.perf_counter() - t_setup


def latencies(answers: list) -> tuple:
    """(latency of each request in s, infinite where it failed; how many
    failed; how many never came; generator lateness of each)."""
    lat, late, failed, missing = [], [], 0, 0
    for a in answers:
        if a["status"] == 200:
            lat.append(a["end"] - a["due"])
        else:
            failed += 1
            missing += a["status"] == 0
            lat.append(math.inf)
        if a["start"] is not None:
            late.append(a["start"] - a["due"])
    return lat, failed, missing, late


def run(cfg: dict, wl: dict, seed: int, seconds: float, trace: bool,
        sync, profile_cls) -> Run:
    import torch
    from repro_torch.obs import REGISTRY

    prog, hosts, counts, setup_s = setup(cfg, wl, seed, sync)
    reqs = mix.schedule(wl, seed, seconds, hosts, counts)
    before = REGISTRY.as_dict()
    if trace:
        prog.gw.tracer.max_traces = len(reqs) + 64
    prof = profile_cls().__enter__() if trace else None
    answers = send(prog.address, reqs, trace)
    sync()
    if prof is not None:
        prof.__exit__(None, None, None)
    after = REGISTRY.as_dict()
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0

    lat, failed, missing, late = latencies(answers)
    ref = Window(prog.rec)
    checks, notes = check_answers(ref, reqs, answers, wl)
    by_route = {}
    for r, a in zip(reqs, answers):
        by_route.setdefault(r["route"], []).append(
            (a["end"] - a["due"]) * 1e3 if a["status"] == 200 else math.inf)
    bad = [{"route": r["route"], "status": a["status"],
            "body": str(a["body"])[:300]}
           for r, a in zip(reqs, answers) if a["status"] != 200]
    notes[:0] = ["gateway: " + json.dumps({
        "requests": len(reqs), "failed": failed, "never_answered": missing,
        "offered_per_s": len(reqs) / seconds, "setup_s": setup_s,
        "p50_ms_by_route": {k: percentile(v, 50) for k, v in by_route.items()},
        "p95_ms_by_route": {k: percentile(v, 95) for k, v in by_route.items()},
        "last_answer_s": max((a["end"] or 0) for a in answers)}),
        "generator lateness (start - due), s: " + json.dumps({
            "p50": percentile(late, 50), "p95": percentile(late, 95),
            "max": max(late) if late else None})] + \
        (["failed requests: " + json.dumps(bad[:5])] if bad else [])
    layer = {"before": before, "after": after, "done": answers,
             "reqs": reqs, "ref": ref}
    if trace:
        spans = [prog.gw.tracer.spans(a["trace_id"]) for a in answers
                 if a.get("trace_id")]
        layer["spans"] = spans
        layer["host"] = [h for s in spans for h in host_intervals(s)]
    prog.close()
    return Run(attempted=len(reqs), failed=failed,
               metrics={"request_p50_ms": 1e3 * percentile(lat, 50),
                        "request_p95_ms": 1e3 * percentile(lat, 95),
                        "setup_s": setup_s},
               checks=checks, extra_correct=missing == 0, notes=notes,
               layer=layer, profile=prof, peak_bytes=peak)


class _Reference:
    """The reference's answer to each kind of request, computed once."""

    def __init__(self, ref: Window, dtype=None):
        import torch
        self.ref, self.dtype = ref, dtype or torch.float64
        self._memo = {}

    def memo(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def degrees(self, prefix):
        """{full key: degree} in this precision."""
        def make():
            import torch
            keys, deg = self.ref.degrees(prefix)
            d = torch.as_tensor(deg, dtype=torch.float64).to(self.dtype)
            return dict(zip((prefix + keys.astype(object)).tolist(),
                            d.to(torch.float64).tolist()))
        return self.memo(("deg", prefix), make)

    def c2(self):
        return self.memo("c2", lambda: self.ref.c2_scores(self.dtype))

    def pagerank(self, iters):
        return self.memo(("pr", iters),
                         lambda: self.ref.pagerank(iters, dtype=self.dtype))


def check_answers(ref: Window, reqs: list, answers: list, wl: dict,
                  dtype=None):
    """The compared numbers over every answered request.  With ``dtype``
    (the control), the reference computed in that precision answers in
    the program's place."""
    want, ctl = _Reference(ref), (_Reference(ref, dtype) if dtype else None)
    gaps = dict.fromkeys(CHECKS, 0.0)

    def worse(name, v):
        gaps[name] = max(gaps[name], float(v))

    for r, a in zip(reqs, answers):
        if a["status"] != 200 or not isinstance(a["body"], dict):
            continue
        p, body = r["params"], a["body"]
        route = r["route"]
        if route == "topk":
            full = want.degrees(p["prefix"])
            if ctl is not None:
                d = ctl.degrees(p["prefix"])
                got = sorted(d.items(), key=lambda kv: -kv[1])[:p["k"]]
            else:
                got = [(h["key"], h["degree"]) for h in body["hosts"]]
            best = sorted(full.values(), reverse=True)[:p["k"]]
            if len(got) != len(best):
                worse("topk_gap", best[0] if best else 1.0)
                continue
            worse("topk_gap", C.keyed_gap([k for k, _ in got],
                                          [v for _, v in got], full))
            worse("topk_gap", max((abs(v - b) for (_, v), b in
                                   zip(got, best)), default=0.0))
        elif route == "scan":
            rows = ref.scan_col(p["key"])
            cut = min(rows.shape[0], int(p["max_cells"]))
            trip = body.get("triples", [])
            bad = abs(int(body.get("nnz", -1)) - rows.shape[0])
            bad += bool(body.get("truncated")) != (rows.shape[0] > cut)
            bad += abs(len(trip) - cut)
            bad += sum(1 for t, w in zip(trip, rows[:cut].tolist())
                       if t[0] != w or t[1] != p["key"] or float(t[2]) != 1.0)
            worse("scan_mismatch", bad)
        elif route == "degree":
            keys, deg = ref.degrees(p["prefix"])
            wfit = fit_rank_size(deg)
            whist = degree_histogram(deg, int(p["bins"]))
            if ctl is not None:
                gfit = fit_rank_size(deg, dtype)
                ghist = degree_histogram(deg, int(p["bins"]), dtype)
                n = keys.shape[0]
            else:
                gfit, n = body["fit"], body["n"]
                ghist = np.asarray(body["histogram"]["counts"], np.float64)
            # the fit's relative error, and the share of keys binned
            # elsewhere than the reference bins them
            worse("degree_rel", max(
                C.fit_rel(gfit, wfit) if n == keys.shape[0] else 1.0,
                np.abs(ghist - whist).sum() / max(n, 1)
                if ghist.shape == whist.shape else 1.0))
        elif route == "c2":
            k = int(p["top_k"])
            wh, ws = want.c2()
            if ctl is not None:
                gh, gs = ctl.c2()
                o = np.argsort(-gs, kind="stable")[:k]
                gh, gs = gh[o], gs[o]
            else:
                rep = body["report"]
                gh, gs = np.asarray(rep["hosts"]), np.asarray(rep["scores"])
            worse("c2_rel", C.ranking(gh, gs, wh, ws, k))
        elif route == "pagerank_job":
            k, iters = int(p["top_k"]), int(p["num_iters"])
            wk, wr = want.pagerank(iters)
            if ctl is not None:
                gk, gr = ctl.pagerank(iters)
                o = np.argsort(-gr, kind="stable")[:k]
                gk, gr, n = gk[o], gr[o], wk.shape[0]
            else:
                res = body.get("result", {})
                gk = np.asarray([x["key"] for x in res.get("nodes", [])])
                gr = np.asarray([x["rank"] for x in res.get("nodes", [])])
                n = res.get("n_nodes")
            worse("pagerank_rel", C.ranking(gk, gr, wk, wr, k)
                  if n == wk.shape[0] else 1.0)
    limits = wl["limits"]
    checks = [Check(k, gaps[k], float(limits[k])) for k in CHECKS
              if k in limits]
    return checks, [f"reference: {ref.n} packets, "
                    f"{ref.dst_keys.shape[0]} destinations"]
