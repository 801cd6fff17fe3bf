#!/usr/bin/env python3
"""Measure a cell's spread: sets of runs, each run a process of its
own.

    python3 bench/sets.py --workload gbe-mem.analyst \\
        --seeds 3000000001,3000000002,... --sets 2 --seconds 51 \\
        [--trace-seeds 3000000101,...] [--out sets.json]

Runs ``bench/run.py`` once a seed, set after set (every set over the same
seeds), then once a trace seed with ``--trace 1``.  For each set and each
end-to-end metric it reports the median and the spread: the distance
between the first and third quartiles of ``statistics.quantiles(values,
n=4)`` over the median.  A bound is set at about five times the wider
spread of the two sets, never under 1%.  Every run's result line and the
end of its standard error are kept in ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def one(cell: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "trace": trace, "rc": proc.returncode,
            "wall_s": time.perf_counter() - t0, "result": result,
            "stderr_tail": proc.stderr[-3000:]}


def spread(values: list) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("inf")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs, sets = [], []
    for k in range(args.sets):
        got = [one(args.workload, s, args.seconds, 0) for s in seeds]
        runs += got
        for r in got:
            print(json.dumps({"set": k, "seed": r["seed"], "rc": r["rc"],
                              "wall_s": r["wall_s"],
                              "result": r["result"]}), flush=True)
        names = sorted({m for r in got if r["result"]
                        for m in r["result"]["metrics"]})
        summary = {}
        for m in names:
            v = [r["result"]["metrics"][m]["value"] for r in got
                 if r["result"] and m in r["result"]["metrics"]]
            summary[m] = {"values": v, "median": statistics.median(v),
                          "spread": spread(v) if len(v) >= 2 else None}
        sets.append(summary)
        print(json.dumps({"set": k, "summary": summary}), flush=True)
    for s in (int(x) for x in args.trace_seeds.split(",") if x):
        r = one(args.workload, s, args.seconds, 1)
        runs.append(r)
        print(json.dumps({"trace_seed": s, "rc": r["rc"],
                          "wall_s": r["wall_s"], "result": r["result"]}),
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seconds": args.seconds,
                       "sets": sets, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
