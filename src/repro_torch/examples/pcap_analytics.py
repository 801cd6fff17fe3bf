"""Deep-dive analytics over a captured window (paper §III-A references),
served entirely through the D4M database binding — the JAX package's
``examples/pcap_analytics.py`` on the port.

The window is ingested once — ``put(T, putval(E, '1,'))`` — and every
analytic below queries the database through ``DB``/``DBTable``
subscripts: column-block scans route through the transpose table
(TedgeT), the power-law background reads the combiner-maintained degree
table (TedgeDeg), and chained algebra over table queries builds a lazy
operator DAG that executes in one fused pass (the ELL kernels on the
card).

Run:  PYTHONPATH=src python -m repro_torch.examples.pcap_analytics
      PYTHONPATH=src python -m repro_torch.examples.pcap_analytics lsm DIR

The optional arguments pick the storage engine from the backend
registry: ``memory`` (default, volatile) or ``lsm <path>`` — the
persistent store, where a re-run against the same path reopens the
previous window from disk (WAL replay + sorted runs) instead of
re-ingesting.
"""
from __future__ import annotations

import os
import sys
import tempfile
from typing import Optional

import numpy as np

from .. import analytics
from ..core import parse_tsv, val2col
from ..db import DB, put
from ..pipeline import TrafficConfig, botnet_truth
from ..pipeline.pcap import records_to_tsv, synth_packets

TRAFFIC = TrafficConfig(n_hosts=512, pkt_rate=400.0, n_bots=16,
                        beacon_period_s=4.0, seed=7)


def run(backend: str = "memory", path: Optional[str] = None) -> dict:
    """Capture and ingest a 60 s window (or reopen ``path``'s), then the
    example's analytics; the results as plain values, with the window's
    field names and ip.src × tcp.dstport correlation beside its field
    statistics (``main`` prints what the JAX package's example prints)."""
    traffic = TRAFFIC
    T = DB('Tedge', 'TedgeT', 'TedgeDeg', backend=backend, path=path,
           n_instances=2, tablets_per_instance=4)
    try:
        out = {"backend": backend, "path": path,
               "reopened": bool(T.n_entries), "n_recovered": T.n_entries}
        if not T.n_entries:
            rec = synth_packets(traffic, 60.0)
            E = val2col(parse_tsv(records_to_tsv(rec)))
            put(T, E.putval("1,"))
            T.flush()   # durable backends fsync here (the commit point)
            del E  # everything below reads back through the binding

        window = T[:, :].eval()
        out.update(shape=tuple(window.shape), n_entries=T.n_entries)

        # dimensional analysis [25]
        out["field_stats"] = analytics.field_stats(window)
        out["top_pairs"] = analytics.top_correlated_pairs(window, top_k=3)
        out["field_names"] = analytics.field_names(window)
        out["corr"] = [np.asarray(x).tolist() for x in
                       analytics.field_correlation(
                           window, "ip.src", "tcp.dstport").triples()]

        # power-law background [26] — straight from TedgeDeg
        fit = analytics.fit_degree_table(T, "ip.dst|")
        out["fit"] = [float(fit.alpha), float(fit.r2)]

        # anomaly detection — detectors query the table directly
        truth = botnet_truth(traffic)
        rep = analytics.detect_c2(T, top_k=5)
        out.update(c2_truth=truth["c2"], c2_port=truth["c2_port"],
                   c2=rep.hosts.tolist(),
                   c2_scores=np.asarray(rep.scores, float).tolist())
        out["scanners"] = np.asarray(
            analytics.scan_detect(T, min_fanout=24)).tolist()

        # Fig. 2: one host's connections as a lazy chain over column scans
        c2 = truth["c2"]
        touched = (T[:, f"ip.src|{c2},"].sum(1) + T[:, f"ip.dst|{c2},"].sum(1))
        conns = (touched.logical().T * T[:, "ip.dst|*,"]
                 ) + (touched.logical().T * T[:, "ip.src|*,"])
        out["connections_nnz"] = conns.eval().nnz
        out["scan_routing"] = str(T.stats)

        # centrality [23] — PageRank from the binding
        hosts, pr = analytics.distributed.pagerank_table(T, num_iters=30)
        pr = pr.cpu().numpy().astype(np.float64)
        top = np.argsort(pr)[::-1][:5]
        out["pagerank"] = ([str(hosts[i]) for i in top], pr[top].tolist())
        return out
    finally:
        T.close()


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    backend = argv[0] if argv else "memory"
    path = argv[1] if len(argv) > 1 else (
        os.path.join(tempfile.gettempdir(), "pcap_analytics_lsm")
        if backend == "lsm" else None)
    r = run(backend, path)
    if r["reopened"]:
        print(f"[{backend}] reopened existing store at {path} "
              f"({r['n_recovered']} entries recovered — skipping ingest)")
    print(f"window: {r['shape'][0]} packets, {r['shape'][1]} field|values "
          f"({r['n_entries']} db entries)")

    print("\nfield structure:")
    for field, st in r["field_stats"].items():
        print(f"  {field:22s} card={st['cardinality']:6d} "
              f"H={st['entropy_bits']:6.2f} bits")
    print("top correlated field pairs:", r["top_pairs"])

    alpha, r2 = r["fit"]
    print(f"\nrank-size fit (from degree table): alpha={alpha:.2f} "
          f"R2={r2:.3f} (internet traffic ~ powerlaw)")

    print(f"\ninjected C2: {r['c2_truth']} on port {r['c2_port']}")
    for h, s in zip(r["c2"], r["c2_scores"]):
        print(f"  candidate {h:16s} score={s:.3f}"
              + ("   <-- C2" if h == r["c2_truth"] else ""))
    scanners = r["scanners"]
    print("scan-like sources:",
          np.asarray(scanners[:5]) if len(scanners) else "none")

    print(f"\nconnections of {r['c2_truth']}: {r['connections_nnz']} "
          f"field|value endpoints (scan routing: {r['scan_routing']})")

    print("\ntop PageRank hosts:")
    for host, rank in zip(*r["pagerank"]):
        print(f"  {host:16s} {rank:.4f}")


if __name__ == "__main__":
    main()
