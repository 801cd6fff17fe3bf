#!/usr/bin/env python3
"""Read a cell's compared numbers on several seeds, for the program and
for its control, at the cell's own size.

    python3 bench/control.py --workload gbe-mem.analyst \\
        --seeds 11,12,13 --seconds 10 [--out control.json]

Each seed is one short run of the cell's loop, as ``bench/run.py`` drives
it.  Its numbers are the program's readings; the same numbers with the
reference computed in bfloat16 put in the program's place (the control:
one step below the float32 the configurations state) are the control's.
For the pipeline cell, whose answers are exact counts, the control is
the reference's store less the writes still queued at the flush barrier
(the writes of the last batch of each capture file), which breaks the
guarantee that every acknowledged packet is read back.  The limits in
the workload files are set between the largest program reading and the
smallest control reading (see PERF.md).  Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import common  # noqa: E402


def control_checks(wl: dict, run) -> dict:
    """The control's readings of one run."""
    import torch
    loop = wl["loop"]
    if loop == "analyst":
        from bench.loops import analyst
        checks, _ = analyst.check_answers(run.layer["ref"], run.layer["done"],
                                          wl, dtype=torch.bfloat16)
    elif loop == "gateway":
        from bench.loops import gateway
        checks, _ = gateway.check_answers(run.layer["ref"], run.layer["reqs"],
                                          run.layer["done"], wl,
                                          dtype=torch.bfloat16)
    else:
        from bench.loops import pipeline
        return pipeline.control_readings(*run.layer["checked"])
    return {c.name: c.value for c in checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    common.setup_paths()
    from bench import run as R
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run, *_ = R.run_cell(args.workload, seed, args.seconds, False)
        wl = common.load_json("workloads", args.workload)
        row = {"seed": seed, "correct": run.correct,
               "program": {c.name: c.value for c in run.checks},
               "control": control_checks(wl, run),
               "metrics": run.metrics}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
