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
from ..models.blocks import (capturable, captured_experts,
                              record_replayed_experts)
from ..obs import REGISTRY, span

# Every decode step of generate counts its path; /metrics shows the
# counts as repro_decode_graph_total{path=...}.
_GRAPH_FAMILY = REGISTRY.counter(
    "repro_decode_graph_total", "Decode steps of generate by path: "
    "captured into a CUDA graph, replayed from it, or run eagerly",
    labels=("path",))
_GRAPH = {p: _GRAPH_FAMILY.labels(path=p)
          for p in ("captured", "replayed", "eager")}


def decode_graph_counts() -> dict:
    """Snapshot of the decode step counters by path (a copy, safe to
    diff)."""
    return {p: c.value for p, c in _GRAPH.items()}


class Generated(NamedTuple):
    """What :func:`generate` hands back with ``details=True``."""
    tokens: torch.Tensor        # (B, max_new) int64 new token ids, host
    logits: list                # max_new + 1 float32 (B, V): the prompt's
                                # last position, then each decode step's


# device -> [capture stream, memory pool id, the last graph captured]:
# every call's decode graph is captured on that stream and allocates
# from that pool, for the process's life
_CAPTURE = {}


def _capture_place(dev: torch.device) -> list:
    """The side stream and the memory pool that decode graphs on ``dev``
    share across calls, and the last graph captured there.  Captured
    allocations come from the pool, and the caching allocator cannot
    free cached memory while a stream captures: a pool made anew at
    every call would need fresh device memory each time, which the
    general pool's cached segments (rings and prefill transients of
    other lengths) may all hold.  The shared pool keeps what the last
    graph used, for the next one to reuse; the last graph is kept until
    the next is captured, since a pool that no graph holds is released
    and cannot be captured into again."""
    if dev not in _CAPTURE:
        _CAPTURE[dev] = [torch.cuda.Stream(dev),
                         torch.cuda.graph_pool_handle(), None]
    return _CAPTURE[dev]


def _capture(params, caches, batch: dict, cfg):
    """One decode step captured into a CUDA graph on a side stream
    (capture runs nothing on the card), its memory from the pool that
    every call's graph shares (:func:`_capture_place`; the graph before
    it is never replayed again, so none overwrites memory another
    reads).  Returns the graph, the logits tensor that each replay
    overwrites, and the grouped-expert calls that a traced replay tags
    (``models.blocks.captured_experts``)."""
    place = _capture_place(batch["tokens"].device)
    stream, pool, _ = place
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), captured_experts() as experts:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            logits, _ = decode_step(params, caches, batch, cfg)
        finally:
            graph.capture_end()
    place[2] = graph            # holds the pool; the graph before it goes
    return graph, logits, experts


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
    (``batch``) each end once the step's tokens are on the host.

    Where ``models.blocks.capturable`` holds and ``max_new`` >= 2, the
    first decode step runs eagerly
    (the warm-up), the second is captured into a CUDA graph over the
    call's own rings and every step from it on is a replay of that
    graph: the host enqueues one launch a step.  The captured step reads
    nothing back to the host and writes the rings in place
    (``models.blocks``); its (B, 1) token and position inputs stay on
    the device, refilled there before each replay; the graph is the
    call's own (kept after it returns only to hold the pool), and its
    memory comes from one pool that every call's graph reuses
    (:func:`_capture_place`).  Sampling stays outside the
    graph; the logits a replay returns are overwritten by the next, so
    ``details`` keeps copies.  In a traced call each replayed step
    records its grouped-expert calls as ``moe.experts`` spans under its
    ``model.decode_step`` (``models.blocks.record_replayed_experts``),
    as an eager step opens them.  Each step counts its path in
    ``repro_decode_graph_total{path="eager"|"captured"|"replayed"}``;
    elsewhere (the CPU, recurrent caches, sharded or head-padded
    models, one step) every step is eager."""
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
    capture_at = 1 if max_new >= 2 and capturable(cfg, caches, dev) \
        else max_new
    graph = None
    for i in range(max_new):
        out_tokens.append(host_ids)
        with span("model.decode_step", batch=n):
            if graph is None:
                db = {"tokens": nxt[:, None].to(torch.int32),
                      "positions": torch.full((n, 1), pos + i,
                                              dtype=torch.int32, device=dev)}
                if enc_zeros is not None:
                    db["enc_out"] = enc_zeros   # a zero encoder output
            else:       # the graph's inputs, refilled on the card
                db["tokens"].copy_(nxt[:, None])
                db["positions"].add_(1)
            if i < capture_at:
                logits, caches = decode_step(params, caches, db, cfg)
                path = "eager"
            else:
                if graph is None:
                    graph, logits, experts = _capture(params, caches, db,
                                                      cfg)
                    path = "captured"
                else:
                    path = "replayed"
                wall0, t0 = time.time(), time.perf_counter()
                graph.replay()
            _GRAPH[path].inc()
            last, nxt, host_ids = pick(logits)
            if graph is not None:
                record_replayed_experts(experts, wall0,
                                        time.perf_counter() - t0)
        if details:
            seen.append(last if graph is None else last.clone())
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
