"""AdamW and the distributed-optimization knobs, as plain functions on
trees of tensors (the JAX package's ``train/optimizer.py``).

``adamw_update`` computes, leaf by leaf in float32 and in the JAX
package's order of operations: global-norm clipping, a linear warmup of
the learning rate, the moment updates, bias correction, and weight
decay on every leaf.  It updates the parameters and the moments in
place and returns them with the gradient norm.  The elementwise
work runs as ``torch._foreach_*`` calls over all leaves at once, in
place on the parameters and moments, with at most two temporaries a
leaf alive at a time.

Two knobs act on the gradient reduction (applied by the trainer):

* ``grad_dtype="bfloat16"`` — gradients cast before the cross-replica
  reduction, halving its bytes;
* ``grad_accum`` — k micro-batches a step, each a sequential gradient
  evaluation, the update applied once to their mean.

``gather_dtype`` casts float32 parameters before use in the loss.

Leaves may be DTensors (the sharded train step's state): the update then
runs on each rank's local shards, which elementwise arithmetic allows,
and :func:`global_norm` sums each shard's squares once over the whole
mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..tree import tree_leaves, tree_map


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
    """sqrt of the sum of every leaf's squares, in float32.  DTensor
    leaves (sharded or replicated, not partial) count each entry once:
    their local sums of squares are summed by placements and all-reduced
    over the axes they are sharded on, one collective a set of
    placements."""
    leaves = tree_leaves(tree)
    plain = [x.to(torch.float32) for x in leaves
             if not isinstance(x, DTensor)]
    if len(plain) == len(leaves):
        sq = torch.stack([torch.sum(torch.square(x)) for x in plain])
        return torch.sqrt(torch.sum(sq))
    groups: dict = {}
    for x in leaves:
        if isinstance(x, DTensor):
            if any(p.is_partial() for p in x.placements):
                raise ValueError("global_norm of a partial DTensor")
            groups.setdefault((x.device_mesh, tuple(x.placements)), []
                              ).append(x.to_local().to(torch.float32))
    parts = [torch.sum(torch.square(x)) for x in plain]
    for (mesh, pls), xs in groups.items():
        local = torch.stack([torch.sum(torch.square(x)) for x in xs]).sum()
        parts.append(DTensor.from_local(
            local, mesh, [Partial() if p.is_shard() else Replicate()
                          for p in pls], run_check=False).full_tensor())
    return torch.sqrt(torch.sum(torch.stack(parts)))


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step.  Returns (params, state, gradient norm): the
    parameters and moments are updated in place and returned (the state
    is donated, as in the JAX package's train step, so a rank never
    holds two copies of it; a caller that needs the old state clones
    it).  The gradients are left as they were; at most two temporaries
    a leaf are alive beside them."""
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    lr = _schedule(step, cfg)
    gnorm = global_norm(grads)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    p = [_local(x) for x in tree_leaves(params)]
    g = [_local(x).to(torch.float32) for x in tree_leaves(grads)]
    if cfg.grad_clip:
        g = torch._foreach_mul(g, torch.clamp(
            cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0))
    m = [_local(x) for x in tree_leaves(state["m"])]
    v = [_local(x) for x in tree_leaves(state["v"])]
    # m = b1 m + (1 - b1) g
    torch._foreach_mul_(m, b1)
    t = torch._foreach_mul(g, 1 - b1)
    torch._foreach_add_(m, t)
    del t
    # v = b2 v + (1 - b2) g g
    torch._foreach_mul_(v, b2)
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
    torch._foreach_sub_(p, upd)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
