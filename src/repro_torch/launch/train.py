"""End-to-end training driver (the JAX package's ``launch/train.py``).

Modes:
* ``--smoke`` — the reduced config of ``--arch`` (the per-arch smoke
  family), on the (1, n) smoke mesh;
* default    — the full config over ``world_mesh()``: one device, or
  every rank under ``torchrun`` (NCCL on the card, gloo with
  ``REPRO_TORCH_DEVICE=cpu``).

In a ``torch.distributed`` world (``torchrun``, or a process group the
caller initialized) the state is placed by ``train.sharding.param_specs``
over the mesh, each layer sliced to the rank's shards as it is made
(``trainer.init_train_state``: no rank holds the whole float32 tree):
under ``world_mesh()`` that is FSDP over the world, parameters and AdamW
moments sharded at rest, each rank's slice of the global batch, the
sharded train step of ``train.trainer``.  One process outside a world
trains on its whole state.

Both train on the D4M pipeline's packet-log corpus (synthesized unless
``--data`` names files), with checkpoint/restart: ``--ckpt-every``
saves parameters, optimizer state and the sampler state asynchronously,
and ``--resume`` continues from the latest checkpoint.  Rank 0 alone
prints and writes; a sharded state is gathered for the save on every
rank.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --steps 12 --seq 512 --batch 8
  PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
      --arch recurrentgemma-9b --steps 4 --seq 512 --batch 8
  REPRO_TORCH_DEVICE=cpu PYTHONPATH=src python -m repro_torch.launch.train \\
      --smoke --steps 20
"""
from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import checkpoint as ckpt
from ..configs import canonical, get_config, smoke_config
from ..data import SamplerState, TokenStream
from ..device import get_device
from ..train import OptConfig
from ..train import sharding as S
from ..train.trainer import init_train_state, make_train_step
from .mesh import make_smoke_mesh, world_mesh


def synth_corpus(workdir: str, n_files: int = 2) -> str:
    """Generate a small packet-log corpus via the D4M pipeline (stage 3
    TSV outputs) if none exists. Returns a glob pattern."""
    from ..db import EdgeStore
    from ..pipeline import PipelineConfig, TrafficConfig, run_pipeline
    pattern = os.path.join(workdir, "*.tsv")
    if not glob.glob(pattern):
        cfg = PipelineConfig(
            workdir=workdir, n_files=n_files, duration_per_file_s=1.0,
            traffic=TrafficConfig(n_hosts=128, pkt_rate=2000.0),
            n_workers=2)
        run_pipeline(cfg, EdgeStore(n_tablets=2))
    return pattern


def _join_world(dev: torch.device) -> bool:
    """Join the process group ``torchrun`` describes in the environment
    (``WORLD_SIZE`` > 1); True when this call created it."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return True


def main(argv=None) -> list:
    """Train; returns the losses of the steps run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--data", default=None,
                    help="glob of text/TSV files (default: synthesize "
                         "packet logs via the pipeline)")
    ap.add_argument("--workdir", default="work/train")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    dev = get_device()
    created = _join_world(dev)
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        return _train(args, dev, rank)
    finally:
        if created:
            dist.destroy_process_group()


def _train(args, dev: torch.device, rank: int) -> list:
    os.makedirs(args.workdir, exist_ok=True)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_smoke_mesh(world) if args.smoke else world_mesh()
    opt = OptConfig(warmup_steps=10)

    data_glob = args.data
    if data_glob is None:
        data_glob = os.path.join(args.workdir, "data", "*.tsv")
        if rank == 0:
            synth_corpus(os.path.dirname(data_glob))
        if dist.is_initialized():
            dist.barrier()
    stream = TokenStream(data_glob, seq_len=args.seq, batch=args.batch)

    # in a world each rank keeps its shards, sliced layer by layer
    params, opt_state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), mesh)
    sharded = dist.is_initialized()
    step0 = 0
    ckpt_dir = os.path.join(args.workdir, f"ckpt_{canonical(args.arch)}")
    if args.resume and ckpt.latest_step(ckpt_dir) is not None:
        sampler_like = stream.state.to_dict()
        shardings = None
        if sharded:
            specs = S.param_specs(params, mesh)
            shardings = (specs, {"m": specs, "v": specs, "step": None},
                         {k: None for k in sampler_like})
        (params, opt_state, sampler), meta = ckpt.restore(
            ckpt_dir, (params, opt_state, sampler_like), mesh=mesh,
            shardings=shardings)
        stream.state = SamplerState.from_dict(
            {k: int(v) for k, v in sampler.items()})
        step0 = meta["step"] + 1
        if rank == 0:
            print(f"resumed from step {meta['step']}")

    train_step = make_train_step(cfg, opt, mesh)
    saver = ckpt.AsyncCheckpointer(ckpt_dir)
    losses = []
    for step in range(step0, args.steps):
        # clip token ids into this config's vocab for smoke runs
        batch = {k: torch.from_numpy(np.minimum(v, cfg.vocab - 1)).to(dev)
                 for k, v in stream.next_batch().items()}
        t0 = time.time()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if rank == 0:
            print(f"step {step:4d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} "
                  f"{time.time()-t0:6.2f}s", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0 and \
                (rank == 0 or sharded):
            saver.save_async(step, (params, opt_state,
                                    stream.state.to_dict()),
                             {"step": step, "loss": loss})
    saver.wait()
    if dev.type == "cuda":
        # each rank's peak device memory, printed by rank 0
        peak = [torch.cuda.max_memory_allocated(dev) / 1e9]
        if dist.is_initialized():
            peak = [None] * dist.get_world_size()
            dist.all_gather_object(peak, torch.cuda.max_memory_allocated(
                dev) / 1e9)
        if rank == 0:
            print(f"peak GB a rank {[round(p, 2) for p in peak]}",
                  flush=True)
    if len(losses) >= 10 and rank == 0:
        first, last = np.mean(losses[:3]), np.mean(losses[-3:])
        print(f"loss {first:.3f} → {last:.3f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
