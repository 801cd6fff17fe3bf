"""The paper's full pipeline as a user script (the "135 lines" artifact)
— the JAX package's ``examples/pcap_pipeline.py`` on the port.

Everything an analyst writes to go from raw compressed captures to a
queryable edge database with degree tables — uncompress → split → parse
→ sort → sparse → ingest — plus the Fig. 2 connection query and the
botnet detection the paper's analytics enable.

Run:  PYTHONPATH=src python -m repro_torch.examples.pcap_pipeline
"""
from __future__ import annotations

import glob
import os
import tempfile
from typing import Optional

import numpy as np

from .. import analytics
from ..core.assoc import Assoc
from ..db import MultiInstanceDB
from ..pipeline import (PipelineConfig, TrafficConfig, botnet_truth,
                        run_pipeline)


def run(workdir: Optional[str] = None) -> dict:
    """The six stages into a two-instance store under ``workdir`` (a new
    temporary directory by default), the connection query and C2
    detection; the results as plain values."""
    workdir = workdir or tempfile.mkdtemp(prefix="d4m_pipeline_")

    # configure the capture + cluster
    traffic = TrafficConfig(
        n_hosts=256,            # the visible host population
        pkt_rate=150.0,         # packets/second on the tap
        n_bots=12,              # injected botnet (ground truth for eval)
        beacon_period_s=5.0,
        seed=42,
    )
    cfg = PipelineConfig(
        workdir=workdir,
        n_files=2,              # capture files (the paper used 385)
        duration_per_file_s=45.0,
        split_size=128 * 1024,  # the paper's 5 MB splits, scaled down
        traffic=traffic,
        n_workers=4,            # worker pool (the paper used 24,640 cores)
    )

    # the paper's §IV-F topology: parallel 16-tablet instances
    db = MultiInstanceDB(n_instances=2, tablets_per_instance=4)

    # run all six stages (journaled: re-running resumes)
    stats = run_pipeline(cfg, db)

    # Fig. 2: find a host's connections straight from the database
    c2 = botnet_truth(traffic)["c2"]
    conns = db.connections(c2)

    # load the incidence matrix and run the analytics
    E = Assoc()
    for path in sorted(glob.glob(os.path.join(workdir, "*.E.npz"))):
        E = E + Assoc.load(path)
    report = analytics.detect_c2(E, top_k=5)
    return {
        "workdir": workdir,
        "bytes": {s: (st.get("bytes_in"), st.get("bytes_out"))
                  for s, st in stats["stages"].items()},
        "db_entries": stats["db_entries"],
        "c2_truth": c2, "connections": conns,
        "degree": db.degree(f"ip.dst|{c2}"),
        "shape": tuple(E.shape),
        "c2": report.hosts.tolist(),
        "scores": np.asarray(report.scores, float).tolist(),
        "fanin": np.asarray(report.fanin, float).tolist(),
    }


def main() -> None:
    r = run()
    print("pipeline stages:")
    for stage, (b_in, b_out) in r["bytes"].items():
        if b_in:
            print(f"  {stage:10s} {b_in:>10d}B → {b_out:>10d}B"
                  f"  ({b_out / b_in:.2f}x)")
    print(f"database entries: {r['db_entries']}")

    c2 = r["c2_truth"]
    print(f"\nconnections of {c2}: {len(r['connections'])} hosts "
          f"(degree {r['degree']:.0f})")
    print(f"incidence matrix: {r['shape'][0]} packets x {r['shape'][1]} "
          f"field|values")

    print("\nC2 candidates (fused fan-in x periodicity x port-concentration):")
    for host, score, fanin in zip(r["c2"], r["scores"], r["fanin"]):
        marker = "  <-- injected C2" if host == c2 else ""
        print(f"  {host:16s} score={score:6.3f} fanin={fanin:4.0f}{marker}")

    if c2 not in r["c2"][:3]:
        raise SystemExit("detection failed")
    print("\ninjected C2 recovered from the traffic. pipeline complete.")


if __name__ == "__main__":
    main()
