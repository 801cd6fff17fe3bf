"""Compare the analytic perf model with FLOPs counted on the port's step
(the JAX package's ``launch/calibrate.py``).

For every architecture a **unit variant** (one pattern period of layers,
grad_accum=1, naive attention, the Python-loop ``"unrolled"`` WKV: the
JAX package's field changes) runs its real train step in the fake
256-rank world of ``launch/dryrun.py`` over the (16, 16) production
mesh, and a :class:`~repro_torch.launch.census.Census` counts its
per-device FLOPs on the local shards.  The analytic model's prediction
for the same configuration (``perfmodel.cell_perf(..., "single")``) is
set beside it.

The two count different things, so the ratio is a band, not 1:
``torch.utils.flop_counter`` counts matmul-class ops only (mm, bmm,
einsum's products, convolutions), where the model also charges
elementwise work (softmax, the RG-LRU combine, AdamW); and the model
assumes every tensor-parallel dim divides the axis, where query heads
that do not divide it (qwen2.5's 40 on 16) are replicated and repeat
their work on every model rank.
PERF.md states the band each arch falls in.

Writes results/torch/calib/<arch>.json and prints a summary table.

Usage:
  python -m repro_torch.launch.calibrate
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from ..configs import ARCHS, get_config
from ..models.config import ModelConfig, ShapeConfig
from ..train import OptConfig
from . import perfmodel as PM
from .dryrun import RESULTS_DIR, WORLDS, fake_world, measure_cell
from .mesh import make_production_mesh

CALIB_DIR = os.path.join(os.path.dirname(RESULTS_DIR), "calib")
UNIT_SHAPE = ShapeConfig("unit_train", 256, 32, "train")


def unit_config(arch: str) -> ModelConfig:
    cfg = get_config(arch)
    period = len(cfg.pattern)
    return dataclasses.replace(
        cfg, n_layers=period, scan_layers=False,
        attention_impl="naive", rwkv_impl="unrolled", rwkv_chunk=8,
        encoder_layers=2 if cfg.is_encdec else 0,
        loss_chunk=0)


def run_arch(arch: str, force: bool = False) -> dict:
    os.makedirs(CALIB_DIR, exist_ok=True)
    path = os.path.join(CALIB_DIR, f"{arch}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = unit_config(arch)
    fake_world(WORLDS["single"])
    rec = measure_cell(cfg, UNIT_SHAPE, make_production_mesh(),
                       OptConfig(grad_accum=1))
    measured = rec["flops"]
    knobs = PM.PerfKnobs(attention_tri=False, grad_accum=1, remat=True)
    predicted = PM.cell_perf(arch, UNIT_SHAPE, "single", knobs,
                             cfg=cfg).flops
    out = {"arch": arch, "unit_layers": cfg.n_layers,
           "measured_flops": measured, "predicted_flops": predicted,
           "ratio": predicted / measured if measured else float("nan"),
           "counted_seconds": rec["compile_s"]}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main():
    torch.set_num_threads(1)
    print(f"{'arch':28s} {'measured':>12s} {'predicted':>12s} "
          f"{'pred/meas':>9s}")
    for arch in ARCHS:
        try:
            r = run_arch(arch)
            print(f"{arch:28s} {r['measured_flops']:12.4e} "
                  f"{r['predicted_flops']:12.4e} {r['ratio']:9.3f}",
                  flush=True)
        except Exception as e:
            print(f"{arch:28s} FAIL {e!r}", flush=True)


if __name__ == "__main__":
    main()
