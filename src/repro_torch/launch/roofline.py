"""Roofline analysis over the dry-run records, on NVIDIA H100 figures —
the JAX package's ``launch/roofline.py`` with the card's constants.

Reads results/torch/dryrun/<cell>.json and derives, per (arch × shape ×
mesh):

  compute term    = FLOPs_per_device / peak_FLOP/s
  memory term     = HBM_bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / link_bw

(the analytic model's numbers are per device, so the formulas divide by
per-card peaks directly).

Hardware, from NVIDIA's H100 Tensor Core GPU datasheet (SXM5):
989 TFLOP/s dense BF16 on the tensor cores (``PEAK_FLOPS``), 3.35 TB/s
HBM3 (``HBM_BW``).  Collectives: both axes of the 16 × 16 production
mesh span more than one 8-card NVLink node, so the collective term uses
the per-card inter-node link, one 400 Gb/s NDR InfiniBand adapter a
card (NVIDIA ConnectX-7 / DGX H100 datasheet): 50 GB/s (``LINK_BW``).
Within a node NVLink 4 gives 450 GB/s per direction a card
(``NVLINK_BW``, 900 GB/s bidirectional), which a collective over an
axis that fits one node would ride instead.

MODEL_FLOPS = 6·N·T (train) / 2·N·T (prefill) / 2·N·B (decode), with
N = active params for MoE; the ratio MODEL_FLOPS / model FLOPs measures
how much counted compute is "useful" (remat recompute and redundancy
push it below 1).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Optional

from ..configs import ARCHS, get_config
from ..models.config import shape_by_name

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores, H100 SXM
HBM_BW = 3.35e12           # B/s, HBM3, H100 SXM
LINK_BW = 50e9             # B/s, 400 Gb/s NDR InfiniBand a card
NVLINK_BW = 450e9          # B/s, NVLink 4 per direction a card

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch", "dryrun")


def model_flops_per_device(arch: str, shape_name: str, n_devices: int
                           ) -> float:
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    n = cfg.n_active_params()
    if shape.kind == "train":
        total = 6.0 * n * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * n * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n * shape.global_batch
    return total / n_devices


def load_cells(tag: str = "") -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(RESULTS_DIR, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("tag", "") != tag:
            continue
        cells.append(rec)
    return cells


def analyze(rec: dict, knobs=None) -> Optional[dict]:
    """Roofline terms for one dry-run cell.

    FLOPs / HBM / collective bytes come from the analytic model
    (launch/perfmodel; launch/calibrate compares it with counted FLOPs).
    The dry-run record supplies the per-device memory footprint and the
    collective census used to check which collective kinds exist.
    """
    if not rec.get("ok") or rec.get("skipped"):
        return None
    from . import perfmodel as PM
    perf = PM.cell_perf(rec["arch"], rec["shape"], rec["mesh"], knobs)
    t_c = perf.flops / PEAK_FLOPS
    t_m = perf.hbm_bytes / HBM_BW
    t_x = perf.coll_bytes / LINK_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    mf = model_flops_per_device(rec["arch"], rec["shape"],
                                rec["n_devices"])
    bound = max(t_c, t_m, t_x)
    # roofline fraction: useful-model-compute time over the bounding term
    frac = (mf / PEAK_FLOPS) / bound if bound > 0 else 0.0
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh")},
        "t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
        "dominant": dom, "model_flops": mf,
        "useful_ratio": mf / perf.flops if perf.flops else 0.0,
        "roofline_fraction": frac,
        "temp_gib": rec["memory"]["temp_bytes"] / 2**30,
        "args_gib": rec["memory"]["argument_bytes"] / 2**30,
        "coll_by_kind": perf.coll_by_kind,
        "census": rec.get("collective_bytes", {}),
        "grad_accum": rec.get("grad_accum"),
    }


def table(tag: str = "") -> list[dict]:
    return [a for a in (analyze(r) for r in load_cells(tag))
            if a is not None]


def fmt_markdown(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | compute s | memory s | collective s |"
           " dominant | MF/model | roofline frac | temp GiB |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2%} "
            f"| {r['temp_gib']:.2f} |")
    return "\n".join(out)


def main():
    rows = table()
    print(fmt_markdown(rows))
    print()
    # summary: worst fractions / most collective-bound
    rows_s = sorted(rows, key=lambda r: r["roofline_fraction"])
    print("worst roofline fractions:")
    for r in rows_s[:6]:
        print(f"  {r['arch']:26s} {r['shape']:12s} {r['mesh']:6s} "
              f"{r['roofline_fraction']:.2%} dom={r['dominant']}")
    coll = sorted(rows, key=lambda r: -(r["t_collective_s"] /
                                        max(r["t_compute_s"], 1e-12)))
    print("most collective-bound (vs compute):")
    for r in coll[:6]:
        print(f"  {r['arch']:26s} {r['shape']:12s} {r['mesh']:6s} "
              f"coll/comp={r['t_collective_s']/max(r['t_compute_s'],1e-12):.2f}")


if __name__ == "__main__":
    main()
