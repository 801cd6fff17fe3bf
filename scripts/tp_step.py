#!/usr/bin/env python3
"""One tensor-parallel train step, timed, on every rank of a
``torchrun`` world: h2o-danube-1.8b at full width with its depth cut,
the state placed over a (1, world) (data, model) mesh by
``init_train_state``, B sequences of S tokens of seeded random ids.
Rank 0 prints each step's seconds (host clock ending in
``torch.cuda.synchronize()``), the loss, each rank's peak device memory
and the card's name and power limit, then one JSON line.

    PYTHONPATH=src torchrun --nproc_per_node 4 scripts/tp_step.py
    REPRO_TORCH_DEVICE=cpu PYTHONPATH=src torchrun --nproc_per_node 4 \\
        scripts/tp_step.py --smoke          # gloo, the reduced config

``PYTHONPATH`` picks the tree that runs, so two trees can be timed one
after the other on the same cards.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import get_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import OptConfig
from repro_torch.train.trainer import init_train_state, make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()

    dev = get_device()
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
        mesh = make_mesh((1, world), ("data", "model"))
        params, opt_state = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), mesh)
        step = make_train_step(cfg, OptConfig(warmup_steps=1), mesh)
        rng = np.random.default_rng(0)
        seconds, losses = [], []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for _ in range(args.steps):
            toks = rng.integers(0, cfg.vocab, (args.batch, args.seq + 1))
            batch = {"tokens": torch.from_numpy(toks[:, :-1]).int().to(dev),
                     "labels": torch.from_numpy(toks[:, 1:]).int().to(dev)}
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            loss = float(m["loss"])
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(loss)
            if rank == 0:
                print(f"step {len(losses) - 1} loss {loss:.4f} "
                      f"{seconds[-1]:.3f} s", flush=True)
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else 0.0)
        peaks = [None] * world
        dist.all_gather_object(peaks, peak)
        if rank == 0:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip() if dev.type == "cuda" else "cpu"
            print(card)
            print(json.dumps({
                "arch": cfg.name, "layers": cfg.n_layers, "mesh": [1, world],
                "batch": args.batch, "seq": args.seq, "losses": losses,
                "step_s": seconds, "peak_gb": peaks}), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
