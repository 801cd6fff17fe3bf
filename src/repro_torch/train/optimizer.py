"""AdamW and the distributed-optimization knobs, as plain functions on
trees of tensors (the JAX package's ``train/optimizer.py``).

``adamw_update`` computes, leaf by leaf in float32 and in the JAX
package's order of operations: global-norm clipping, a linear warmup of
the learning rate, the moment updates, bias correction, and weight
decay on every leaf.  It returns new parameters, a new state and the
gradient norm, and leaves its arguments as they were.  The elementwise
work runs as ``torch._foreach_*`` calls over all leaves at once, with at
most two temporaries a leaf alive at a time.

Two knobs act on the gradient reduction (applied by the trainer):

* ``grad_dtype="bfloat16"`` — gradients cast before the cross-replica
  reduction, halving its bytes;
* ``grad_accum`` — k micro-batches a step, each a sequential gradient
  evaluation, the update applied once to their mean.

``gather_dtype`` casts float32 parameters before use in the loss.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    grad_dtype: Optional[str] = None     # "bfloat16" halves reduce bytes
    gather_dtype: Optional[str] = None   # "bfloat16" halves FSDP gathers
    grad_accum: int = 1


def adamw_init(params) -> dict:
    """Zero moments shaped like ``params`` and an int32 step of 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    leaves = [x.to(torch.float32) for x in tree_leaves(tree)]
    sq = torch.stack([torch.sum(torch.square(x)) for x in leaves])
    return torch.sqrt(torch.sum(sq))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step.  Returns (new params, new state, gradient norm)."""
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    lr = _schedule(step, cfg)
    gnorm = global_norm(grads)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    p = tree_leaves(params)
    g = [x.to(torch.float32) for x in tree_leaves(grads)]
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        g = torch._foreach_mul(g, scale)
    # m = b1 m + (1 - b1) g
    m = torch._foreach_mul(tree_leaves(state["m"]), b1)
    t = torch._foreach_mul(g, 1 - b1)
    torch._foreach_add_(m, t)
    # v = b2 v + (1 - b2) g g
    v = torch._foreach_mul(tree_leaves(state["v"]), b2)
    t = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(t, g)
    torch._foreach_add_(v, t)
    del t, g
    # p - lr (m̂ / (sqrt(v̂) + eps) + wd p)
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(m, bc1)
    torch._foreach_div_(upd, denom)
    del denom
    t = torch._foreach_mul(p, cfg.weight_decay)
    torch._foreach_add_(upd, t)
    del t
    torch._foreach_mul_(upd, lr)
    new_p = torch._foreach_sub(p, upd)
    del upd
    return (tree_unflatten(params, new_p),
            {"m": tree_unflatten(params, m), "v": tree_unflatten(params, v),
             "step": step},
            gnorm)
