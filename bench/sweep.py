#!/usr/bin/env python3
"""Find the highest rate a gateway cell's deployment sustains.

    python3 bench/sweep.py --workload gbe-net.mix --seed <n> \\
        --seconds 30 --rates 2,3,4,6,8 [--out bench/sweeps/<cell>.json]

One set-up (ingest, gateway, warm-up), then the cell's mix offered at
each rate in turn (events a second: requests, or bursts for a bursty
mix) for ``--seconds`` each, open loop, as the benchmark offers it.  For
each rate it records the requests' p50 and p95 latency, the failures,
the p95 of the window's first and second halves, and the backlog: the
requests still unanswered when the last one fell due.  A rate is
sustained when its backlog is no more than the requests of one second
and the second half's p95 is at most 1.5 times the first half's.  Rates
go in the order given, and the sweep stops at the first one not
sustained.  The cell's rate is then set by hand at 0.8 of the highest
sustained rate.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import common  # noqa: E402


def measure(answers: list, seconds: float) -> dict:
    from bench.loops.gateway import latencies
    lat, failed, missing, _ = latencies(answers)
    half = seconds / 2
    first = [x for a, x in zip(answers, lat) if a["due"] < half]
    second = [x for a, x in zip(answers, lat) if a["due"] >= half]
    last_due = max(a["due"] for a in answers)
    backlog = sum(1 for a in answers
                  if a["status"] != 200 or a["end"] > last_due)
    p95_1, p95_2 = (common.percentile(v, 95) * 1e3 for v in (first, second))
    return {"requests": len(answers), "failed": failed,
            "never_answered": missing,
            "p50_ms": common.percentile(lat, 50) * 1e3,
            "p95_ms": common.percentile(lat, 95) * 1e3,
            "p95_first_half_ms": p95_1, "p95_second_half_ms": p95_2,
            "backlog_at_last_due": backlog,
            "steady": backlog <= len(answers) / seconds and
            p95_2 <= 1.5 * p95_1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    common.setup_paths()
    import torch
    from bench.loops import gateway
    from bench.traffic import mix
    spec = common.benchmark_spec()
    entry = next(w for w in spec["workloads"] if w["name"] == args.workload)
    wl = common.load_json("workloads", args.workload)
    cfg = common.load_json("configs", entry["config"])
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    prog, hosts, counts, setup_s = gateway.setup(cfg, wl, args.seed, sync)
    out = {"workload": args.workload, "seed": args.seed,
           "seconds": args.seconds, "setup_s": setup_s,
           "device": torch.cuda.get_device_name(0)
           if torch.cuda.is_available() else "cpu", "rates": []}
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            reqs = mix.schedule(wl, args.seed, args.seconds, hosts, counts,
                                rate=rate)
            row = dict(rate_per_s=rate, **measure(
                gateway.send(prog.address, reqs, False), args.seconds))
            base = out["rates"][0]["p95_ms"] if out["rates"] else row["p95_ms"]
            row["sustained"] = row["steady"] and row["p95_ms"] <= 1.5 * base
            out["rates"].append(row)
            print(json.dumps(row), flush=True)
            if not row["sustained"]:
                break           # a backlog left behind would load the next
    finally:
        prog.close()
    ok = [r["rate_per_s"] for r in out["rates"] if r["sustained"]]
    out["highest_sustained_per_s"] = max(ok) if ok else None
    print(json.dumps({"highest_sustained_per_s": out["highest_sustained_per_s"]}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
