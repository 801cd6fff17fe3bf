"""Batched serving driver: one prefill, then decode steps, with the
model's recurrent caches — on the card by default
(:func:`repro_torch.device.get_device`).

Vision configs get a zero image prefix and encoder–decoder configs zero
frames (and a zero encoder output at every decode step), as the JAX
package's ``generate`` gives them.

Usage (the reduced config of ``--arch``, random weights):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --prompt "ip.src|1.1.1.1" --max-new 32
  REPRO_TORCH_DEVICE=cpu PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-3b-a800m
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..data import tokenizer as T
from ..device import get_device
from ..models import decode_step, init_params, prefill
from ..obs import span


class Generated(NamedTuple):
    """What :func:`generate` hands back with ``details=True``."""
    tokens: torch.Tensor        # (B, max_new) int64 new token ids, host
    logits: list                # max_new + 1 float32 (B, V): the prompt's
                                # last position, then each decode step's


def generate(cfg, params, prompts, max_new: int = 32,
             s_max: int = 256, temperature: float = 0.0, seed: int = 0,
             details: bool = False):
    """Batched greedy/temperature sampling on the parameters' device.

    ``prompts`` are strings, left-padded with token 0 to the longest, or
    a (B, S) tensor of token ids.  Decode positions continue after the
    prompt and, for vision configs, after the image prefix.  Returns the
    decoded strings (string prompts) or the (B, max_new) new ids (id
    prompts); with ``details`` a :class:`Generated`.  Spans
    ``model.prefill`` (``batch``, ``tokens``) and ``model.decode_step``
    (``batch``) each end once the step's tokens are on the host."""
    dev = params["embed"].device
    if isinstance(prompts, torch.Tensor):
        batch = prompts.to(device=dev, dtype=torch.int32)
    else:
        toks = [np.minimum(T.encode(p), cfg.vocab - 1) for p in prompts]
        host = np.full((len(toks), max(t.shape[0] for t in toks)), 0,
                       np.int32)
        for i, t in enumerate(toks):
            host[i, -t.shape[0]:] = t       # left-pad
        batch = torch.from_numpy(host).to(dev)
    n, max_len = batch.shape
    D = cfg.d_model
    pb = {"tokens": batch}
    if cfg.frontend == "vision":
        pb["img_embeds"] = torch.zeros((n, cfg.n_img_tokens, D),
                                       dtype=torch.float32, device=dev)
    enc_zeros = None
    if cfg.is_encdec:
        pb["frames"] = torch.zeros((n, cfg.encoder_seq, D),
                                   dtype=torch.float32, device=dev)
        enc_zeros = torch.zeros_like(pb["frames"])
    gen = torch.Generator(device=dev).manual_seed(seed)

    def pick(logits):
        last = logits[:, -1]
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return last, nxt, nxt.tolist()

    with span("model.prefill", batch=n, tokens=n * max_len):
        logits, caches = prefill(params, pb, cfg, s_max=s_max)
        last, nxt, host_ids = pick(logits)
    seen, out_tokens = [last], []
    pos = max_len + (cfg.n_img_tokens if cfg.frontend == "vision" else 0)
    for _ in range(max_new):
        out_tokens.append(host_ids)
        db = {"tokens": nxt[:, None].to(torch.int32),
              "positions": torch.full((n, 1), pos, dtype=torch.int32,
                                      device=dev)}
        if enc_zeros is not None:
            db["enc_out"] = enc_zeros   # a zero encoder output every step
        with span("model.decode_step", batch=n):
            logits, caches = decode_step(params, caches, db, cfg)
            last, nxt, host_ids = pick(logits)
        if details:
            seen.append(last)
        pos += 1
    new = torch.tensor(out_tokens, dtype=torch.int64).reshape(max_new, n).T
    if details:
        return Generated(new, seen)
    if isinstance(prompts, torch.Tensor):
        return new
    return [T.decode(row.numpy()) for row in new]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--prompt", action="append", default=None)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, torch.Generator(device=get_device())
                         .manual_seed(0))
    prompts = args.prompt or ["ip.src|1.1.1.1 talked to",
                              "tcp.dstport|6667 beacons from"]
    t0 = time.time()
    outs = generate(cfg, params, prompts, max_new=args.max_new)
    dt = time.time() - t0
    n_tok = args.max_new * len(prompts)
    for p, o in zip(prompts, outs):
        print(f"PROMPT {p!r}\n  → {o!r}")
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok/dt:.1f} tok/s batched) on "
          f"{params['embed'].device}")


if __name__ == "__main__":
    main()
