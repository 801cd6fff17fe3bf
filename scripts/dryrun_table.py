#!/usr/bin/env python3
"""Print the dry-run records under results/torch/dryrun/ as a markdown
table: per-device memory (arguments + peak temporaries) and whether it
fits one 80 GB H100, counted per-device TFLOP, collective GB by kind
(census), and the roofline terms on the H100 constants (dominant term,
roofline fraction).  Run after ``python -m repro_torch.launch.dryrun
--all``:

    PYTHONPATH=src python3 scripts/dryrun_table.py [--mesh single|multi]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import roofline  # noqa: E402

CARD_BYTES = 80e9
KINDS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
         "all-to-all": "A2A", "collective-permute": "CP"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--grid", action="store_true",
                    help="one row an arch: GiB a device and the roofline "
                         "fraction of each shape")
    args = ap.parse_args()
    recs = [r for r in roofline.load_cells() if r["mesh"] == args.mesh]
    if args.grid:
        grid(recs)
        return
    print("| arch | shape | GiB/dev | fits 80 GB | TFLOP/dev | coll GB "
          "by kind | dominant | roofline frac |")
    print("|---|---|---|---|---|---|---|---|")
    failed, skipped = [], []
    for r in recs:
        if r.get("skipped"):
            skipped.append(f"{r['arch']} {r['shape']}")
            continue
        if not r.get("ok"):
            failed.append(f"{r['arch']} {r['shape']}: {r.get('error')}")
            continue
        mem = r["memory"]
        dev = mem["argument_bytes"] + mem["temp_bytes"]
        coll = ", ".join(f"{KINDS[k]} {v / 1e9:.2f}" for k, v in
                         r["collective_bytes"].items() if k != "total")
        a = roofline.analyze(r)
        print(f"| {r['arch']} | {r['shape']} | {dev / 2**30:.2f} | "
              f"{'yes' if dev <= CARD_BYTES else 'no'} | "
              f"{r['flops'] / 1e12:.3f} | {coll} | {a['dominant']} | "
              f"{a['roofline_fraction']:.2%} |")
    secs = sum(r.get("lower_s", 0) + r.get("compile_s", 0) for r in recs)
    print(f"\nseconds of the counted cells (lower_s + compile_s): "
          f"{secs:.1f}")
    print(f"skipped: {len(skipped)} ({'; '.join(skipped)})")
    print(f"failed: {len(failed)}" + "".join(f"\n- {f}" for f in failed))


def grid(recs: list) -> None:
    shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    cells = {(r["arch"], r["shape"]): r for r in recs}
    print("| arch | " + " | ".join(shapes) + " |")
    print("|---|" + "---|" * len(shapes))
    for arch in sorted({r["arch"] for r in recs}):
        row = []
        for shape in shapes:
            r = cells.get((arch, shape))
            if r is None:
                row.append("not run")
            elif r.get("skipped"):
                row.append("skip")
            elif not r.get("ok"):
                row.append("FAIL")
            else:
                dev = r["memory"]["argument_bytes"] + \
                    r["memory"]["temp_bytes"]
                a = roofline.analyze(r)
                row.append(f"{dev / 2**30:.1f} / {a['roofline_fraction']:.2%}")
        print(f"| {arch} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main()
