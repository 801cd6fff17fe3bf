"""One analyst in a closed loop over the in-process store, through the
library (``DBTable`` / ``LazyAssoc`` / ``analytics``).

Set-up makes the window's packets from the seed (the frozen generator),
hands the program their TSV, parses and ingests it into the configured
store, flushes, and runs one warm-up round of every call.  The window
then runs rounds back to back: each round makes the workload's calls in
an order shuffled from the seed, each call ending in a device
synchronise, the next made only when the last has returned.  The window
closes at the first call boundary after ``seconds``;
``requests_per_s`` is the calls completed over the time from the
window's start to the last call's end.  Once the window has closed the
reference rebuilds every answer from the records and each call's answer
is compared with it.
"""
from __future__ import annotations

import time

import numpy as np

from bench.harness.common import Check, Run
from bench.harness.spans import host_intervals
from bench.reference import compare as C
from bench.reference.d4m import Window, fit_rank_size
from bench.traffic import frozen_window, ranked_hosts
from bench.yardstick.ell_bytes import ell_seconds

CALLS = ("fit_degree_table", "detect_c2", "eval_batch", "solo_chain",
         "pagerank_table")


class Analyst:
    """The program under test, set up over one window, and its calls."""

    def __init__(self, cfg: dict, wl: dict, seed: int):
        from repro_torch import analytics
        from repro_torch.core import Assoc, eval_batch, lazy
        from repro_torch.core.schema import parse_tsv, val2col
        from repro_torch.db import DB, put
        self._analytics, self._Assoc = analytics, Assoc
        self._eval_batch, self._lazy = eval_batch, lazy
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
        self.wl = wl
        self.rng = np.random.default_rng([seed, 0xA7A1])
        # the batch's hosts: the window's destinations, drawn without
        # replacement in proportion to the packets they received
        self.hosts, counts = ranked_hosts(self.rec)
        self.host_p = counts / counts.sum()

    def draw_hosts(self) -> list:
        idx = self.rng.choice(self.hosts.shape[0], replace=False,
                              size=int(self.wl["batch_hosts"]),
                              p=self.host_p)
        return [str(self.hosts[i]) for i in idx]

    def call(self, kind: str):
        """One call; returns what is needed to check its answer."""
        T, a = self.T, self._analytics
        if kind == "fit_degree_table":
            return a.fit_degree_table(T, "ip.dst|")
        if kind == "detect_c2":
            return a.detect_c2(T, top_k=int(self.wl["c2_top_k"]))
        if kind == "eval_batch":
            hosts = self.draw_hosts()
            x = [self._Assoc(np.asarray([f"ip.dst|{h}", f"ip.src|{h}"]),
                             np.asarray([h, h]), np.ones(2)) for h in hosts]
            return hosts, self._eval_batch([T.lazy() * self._lazy(v)
                                            for v in x])
        if kind == "solo_chain":
            deg = T.degree_assoc("ip.dst|")
            return (T.lazy() * self._lazy(deg)).eval()
        if kind == "pagerank_table":
            return a.distributed.pagerank_table(
                T, num_iters=int(self.wl["pagerank_iters"]))
        raise ValueError(f"unknown call {kind!r}")

    def close(self) -> None:
        self.T.close()


def run(cfg: dict, wl: dict, seed: int, seconds: float, trace: bool,
        sync, profile_cls) -> Run:
    import torch
    from torch.profiler import record_function
    from repro_torch.obs import Tracer

    t_setup = time.perf_counter()
    prog = Analyst(cfg, wl, seed)
    for kind in CALLS:                      # warm-up: every call once
        prog.call(kind)
        sync()
    setup_s = time.perf_counter() - t_setup

    tracer = Tracer(max_traces=1 << 16, max_spans=4096) if trace else None
    order = np.random.default_rng([seed, 0x0D3])
    done = []       # (kind, wall start, wall end, answer, trace id)
    failed = 0
    prof = profile_cls().__enter__() if trace else None
    t_start = time.perf_counter()
    t_end, stop = t_start, False
    while not stop:
        for k in order.permutation(len(CALLS)):
            if time.perf_counter() - t_start >= seconds:
                stop = True
                break
            kind, tid, w0 = CALLS[int(k)], None, time.time()
            try:
                if tracer is not None:
                    root = tracer.start(kind)
                    tid = root.trace_id
                    with root, record_function(f"bench.{kind}"):
                        out = prog.call(kind)
                        sync()
                else:
                    out = prog.call(kind)
                    sync()
            except Exception as e:          # counted; the run is not correct
                failed += 1
                out = e
            t_end = time.perf_counter()
            done.append((kind, w0, time.time(), out, tid))
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0

    ref = Window(prog.rec)
    checks, notes = check_answers(ref, done, wl)
    kinds, counts = np.unique([d[0] for d in done], return_counts=True)
    notes.insert(0, f"analyst: {len(done)} calls in {t_end - t_start:.4f} s "
                    f"after {setup_s:.4f} s of set-up: "
                    f"{dict(zip(kinds.tolist(), counts.tolist()))}")
    layer = analyst_layer(tracer, done, ref) if tracer is not None else {}
    layer.update(done=done, ref=ref)        # for the control's readings
    prog.close()
    return Run(attempted=len(done), failed=failed,
               metrics={"requests_per_s": len(done) / (t_end - t_start),
                        "setup_s": setup_s},
               checks=checks, extra_correct=failed == 0, notes=notes,
               layer=layer, profile=prof, peak_bytes=peak)


def check_answers(ref: Window, done: list, wl: dict, dtype=None):
    """The compared numbers over every call of the window, and a note.
    With ``dtype`` set (the control), the reference computed in that
    precision stands in for each of the program's answers."""
    import torch
    top_k, iters = int(wl["c2_top_k"]), int(wl["pagerank_iters"])
    keys, deg = ref.degrees("ip.dst|")
    want_fit = fit_rank_size(deg)
    want_h, want_s = ref.c2_scores()
    want_pr = ref.pagerank(iters)
    want_solo = ref.degree_chain()
    gaps = dict.fromkeys(("chain_gap", "fit_rel", "c2_rel", "pagerank_rel"),
                         0.0)

    def worse(name, v):
        gaps[name] = max(gaps[name], float(v))

    for kind, _, _, out, _ in done:
        if isinstance(out, Exception):
            continue
        if kind == "fit_degree_table":
            got = fit_rank_size(deg, dtype) if dtype is not None else {
                "alpha": float(out.alpha), "log_c": float(out.log_c),
                "r2": float(out.r2)}
            worse("fit_rel", C.fit_rel(got, want_fit))
        elif kind == "detect_c2":
            if dtype is not None:
                h, s = ref.c2_scores(dtype)
                o = np.argsort(-s, kind="stable")[:top_k]
                got_h, got_s = h[o], s[o]
            else:
                got_h, got_s = np.asarray(out.hosts), np.asarray(out.scores)
            worse("c2_rel", C.ranking(got_h, got_s, want_h, want_s, top_k))
        elif kind == "eval_batch":
            hosts, cols = out
            for h, col in zip(hosts, cols):
                want = ref.indicator_chain(h)
                got = want if dtype is not None else C.assoc_column(col, h)
                worse("chain_gap", C.column_gap(got, want))
        elif kind == "solo_chain":
            got = ref.degree_chain(dtype) if dtype is not None else \
                C.assoc_column(out, "degree")
            worse("chain_gap", C.column_gap(got, want_solo))
        elif kind == "pagerank_table":
            got = ref.pagerank(iters, dtype=dtype) if dtype is not None \
                else (np.asarray(out[0]),
                      out[1].detach().cpu().to(torch.float64).numpy())
            worse("pagerank_rel", C.vector_rel(got, want_pr))
    limits = wl["limits"]
    checks = [Check(k, v, float(limits[k])) for k, v in gaps.items()]
    c2 = want_h[np.argsort(-want_s, kind="stable")[:3]]
    return checks, [f"reference: {ref.n} packets, {keys.shape[0]} "
                    f"destinations, C2 ranking {c2.tolist()}"]


def analyst_layer(tracer, done: list, ref: Window) -> dict:
    """What this loop's per-layer readers read: each call's spans, the
    host intervals that name idle gaps, and the least device time of each
    ELL launch, counted from the reference's own factor: every packet's
    entries under the chain's host columns (eval_batch), or under every
    ``ip.dst|`` column (the solo chain), over all of the table's rows."""
    spans, host, ell = [], [], []
    dst = dict(zip(ref.dst_keys.tolist(), ref.dst_deg.tolist()))
    src = dict(zip(ref.src_keys.tolist(), ref.src_deg.tolist()))
    for kind, w0, w1, out, tid in done:
        sp = tracer.spans(tid)
        spans.append(sp)
        host.extend(host_intervals(sp))
        if isinstance(out, Exception):
            continue
        if kind == "eval_batch":
            hosts = out[0]
            nnz = sum(dst.get(h, 0) + src.get(h, 0) for h in hosts)
            inner = sum((h in dst) + (h in src) for h in hosts)
            ell.append((w0, w1, "spmm_ell_kernel",
                        ell_seconds(nnz, inner, ref.n, len(hosts))))
        elif kind == "solo_chain":
            ell.append((w0, w1, "spmv_ell_kernel",
                        ell_seconds(ref.n, len(dst), ref.n, 1)))
    return {"spans": spans, "host": host, "ell": ell}
