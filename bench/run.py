#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is found by name in BENCHMARK.json; its workload file
(``bench/workloads/<cell>.json``) names the loop that drives it
(``bench/loops/<loop>.py``) and its configuration
(``bench/configs/<config>.json``).  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, each read by
``bench/metrics/<metric>.py`` from a traced window.  The last line on
standard output is one JSON object; the compared numbers, each beside
its limit, are the last lines on standard error.  Without a CUDA device,
or with fewer than the cell asks for, it exits with code 2 and prints no
result; with JAX or the JAX package loaded at the close, with code 3.
See bench/README.md.
"""
from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import common  # noqa: E402


def cell_entry(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise common.BenchError(f"no cell named {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, name: str, trace: bool) -> list:
    """The metric entries this cell reports in a run of this kind."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             require_cuda: bool = True, spec: dict | None = None,
             overrides: dict | None = None):
    """Drive one run of cell ``name``; returns (Run, metric entries,
    device record, breakdown).  ``require_cuda=False`` and
    ``overrides`` (merged into the configuration and the workload) let
    the CPU tests drive the same path at a tiny size."""
    import torch
    spec = spec or common.benchmark_spec()
    entry = cell_entry(spec, name)
    chips = int(entry["chips"])
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        raise common.BenchError(
            f"cell {name} needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    wl = common.load_json("workloads", name)
    cfg = common.load_json("configs", entry["config"])
    for part, extra in (overrides or {}).items():
        {"config": cfg, "workload": wl}[part].update(extra)
    loop = importlib.import_module(f"bench.loops.{wl['loop']}")
    from bench.harness.profile import DeviceProfile, device_fields
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    run = loop.run(cfg, wl, int(seed), float(seconds), bool(trace), sync,
                   DeviceProfile)
    metrics = metrics_of(spec, name, trace)
    if trace:
        for m in metrics:
            reader = common.load_module("metrics", m["name"])
            run.metrics[m["name"]] = reader.read(run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(run.peak_bytes)} \
        if on_card else {"platform": "cpu", "kind": "cpu", "count": 0,
                         "memory_peak_bytes": 0}
    device.update(device_fields(run.profile))
    breakdown = run.profile.breakdown(run.layer.get("host", [])) \
        if run.profile is not None else None
    return run, metrics, device, breakdown


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    common.setup_paths()
    try:
        run, metrics, device, breakdown = run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace))
    except common.BenchError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    bad = common.forbidden_loaded()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    common.emit(run, [m["name"] for m in metrics],
                {m["name"]: m["unit"] for m in metrics}, device, breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
