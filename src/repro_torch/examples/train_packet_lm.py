"""End-to-end driver: D4M pipeline corpus → LM training → generation —
the JAX package's ``examples/train_packet_lm.py`` on the port.

The framework integration the paper's Fig. 1 gestures at: the same
high-level environment runs the ingest pipeline AND trains/serves a
model on its output.  Uses the reduced rwkv6 config (its chunked WKV,
no hand-written kernel), 30 steps of 4 × 128 tokens.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_packet_lm
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..configs import smoke_config
from ..data import TokenStream
from ..device import get_device
from ..launch.mesh import make_smoke_mesh
from ..launch.serve import generate
from ..launch.train import synth_corpus
from ..models import init_params
from ..train import OptConfig, adamw_init, make_train_step

STEPS = 30


def run(workdir: Optional[str] = None, params: Optional[dict] = None
        ) -> dict:
    """Stage the corpus under ``workdir`` (a new temporary directory by
    default), train from ``params`` (default: the seeded init on the
    device) and sample; the losses and the generated text."""
    workdir = workdir or tempfile.mkdtemp(prefix="packet_lm_")
    dev = get_device()

    # stage the corpus through the pipeline
    pattern = synth_corpus(os.path.join(workdir, "data"), n_files=2)
    stream = TokenStream(pattern, seq_len=128, batch=4)

    # train a reduced rwkv6 on packet logs; one process drives one device
    cfg = smoke_config("rwkv6-1.6b")
    mesh = make_smoke_mesh(1)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=5), mesh)
    losses = []
    for _ in range(STEPS):
        batch = {k: torch.from_numpy(np.minimum(v, cfg.vocab - 1)).to(dev)
                 for k, v in stream.next_batch().items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))

    # generate packet-log-ish text
    outs = generate(cfg, params, ["64.22."], max_new=24, s_max=192)
    return {"losses": losses, "outs": outs}


def main() -> None:
    r = run()
    losses = r["losses"]
    for step in range(0, STEPS, 5):
        print(f"step {step:3d}  loss {losses[step]:.4f}")
    print(f"\nloss: {np.mean(losses[:5]):.3f} → {np.mean(losses[-5:]):.3f}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise SystemExit("no learning?")
    print("sample:", repr(r["outs"][0]))
    print("\ntrained on pipeline output; loss improved. done.")


if __name__ == "__main__":
    main()
