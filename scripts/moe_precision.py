#!/usr/bin/env python3
"""bf16 against float32 for granite-moe-3b-a800m at full width, on the
CPU: the relative norm error of the prefill's last-position logits (over
the real vocabulary) between ``dtype="bfloat16"`` and ``"float32"`` on
the same seeded weights, over the first L layers, for chip_smoke's serve
prompts (packet-log text).

It shows how far the two can be held apart at depth: a (token, choice)
pair whose two best experts nearly tie routes differently in bf16 and
float32, reorders its expert's capacity queue (moving which later pairs
drop), and the next layers amplify the difference.

    PYTHONPATH=src python scripts/moe_precision.py --layers 1 2 4 8
    PYTHONPATH=src python scripts/moe_precision.py --layers 2 8 --no-drops
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/moe_precision.py \\
        --layers 1 2 --with-jax

``--no-drops`` sets the capacity factor to E / k (C = S: no pair
drops); ``--with-jax`` runs the JAX package's model on the same weights
beside the port (both packages must be importable).  Weights come from
the JAX package's init with ``--with-jax``, else the port's, seed 0.
About 10-20 s per depth at 8 prompts.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCH = "granite-moe-3b-a800m"


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--no-drops", action="store_true")
    ap.add_argument("--with-jax", action="store_true")
    args = ap.parse_args()

    from chip_smoke import serve_prompts
    from repro_torch.configs import get_config
    from repro_torch.data import tokenizer as T
    from repro_torch.device import set_device
    from repro_torch.models import init_params, model as PM, params_from_jax
    set_device("cpu")
    base = get_config(ARCH)
    if args.no_drops:
        base = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=base.moe.n_experts / base.moe.top_k))
    prompts = serve_prompts()[:args.prompts]
    toks = np.stack([np.minimum(T.encode(p), base.vocab - 1)
                     for p in prompts]).astype(np.int32)
    for n in args.layers:
        cfg = dataclasses.replace(base, n_layers=n)
        logits = {}
        if args.with_jax:
            import jax
            import jax.numpy as jnp
            from repro.models import model as JM
            tree = jax.tree.map(np.asarray, JM.init_params(
                cfg, jax.random.key(0)))
            params = params_from_jax(cfg, tree, device="cpu")
            jp = jax.tree.map(jnp.asarray, tree)
        else:
            params = init_params(cfg, torch.Generator().manual_seed(0))
        for dt in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, dtype=dt)
            with torch.no_grad():
                x, _ = PM.forward(params, {"tokens": torch.from_numpy(toks)},
                                  c, mode="prefill")
                logits[dt] = PM.logits_from_hidden(
                    params, x[:, -1:], c)[..., :cfg.vocab]
            if args.with_jax:
                xj, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, c,
                                   mode="prefill")
                logits["jax " + dt] = torch.from_numpy(np.asarray(
                    JM.logits_from_hidden(jp, xj[:, -1:], c),
                    np.float32)[..., :cfg.vocab])
        line = (f"layers {n}: port bf16 vs float32 "
                f"{rel(logits['bfloat16'], logits['float32']):.4g}")
        if args.with_jax:
            line += (f"; JAX bf16 vs float32 "
                     f"{rel(logits['jax bfloat16'], logits['jax float32']):.4g}"
                     f"; port vs JAX float32 "
                     f"{rel(logits['float32'], logits['jax float32']):.4g}")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
