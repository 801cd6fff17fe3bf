"""Train-step and serve-step factories (the JAX package's
``train/trainer.py``).

``make_train_step`` builds the update: loss → gradients (``grad_accum``
micro-batches, their mean) → optional ``grad_dtype`` cast → mean over
the mesh's batch axes → AdamW.  Data parallelism is explicit here, where
the JAX package shards the batch over ``data`` and lets XLA insert the
reduction: each rank takes its slice of the global batch, and the
gradients and the loss are summed with ``all_reduce`` over each batch
axis's process group and divided by the ranks' count.  That mean equals
the whole batch's only when every rank holds as many counted tokens,
which holds for :class:`~repro_torch.data.TokenStream` batches (no label
is ``ignore_id``).  Parameters and optimizer state stay whole on every
rank; FSDP and tensor-parallel placements (``train.sharding``) are not
applied inside the step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..models import model as M
from ..models.config import ModelConfig
from ..tree import tree_leaves, tree_map, tree_unflatten
from . import sharding as S
from .optimizer import OptConfig, adamw_init, adamw_update


def _local_batch(batch: dict, mesh, profile: str) -> dict:
    """This rank's slice of the global batch along the mesh's batch
    axes (row-major over them); the whole batch where it does not tile
    them, as the JAX package replicates such batches."""
    if mesh is None:
        return batch
    axes = S.batch_axis_tuple(mesh, profile)
    n = math.prod(mesh.shape[a] for a in axes)
    b = next(iter(batch.values())).shape[0]
    if n == 1 or b % n:
        return batch
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.index(a)
    per = b // n
    return {k: v[i * per:(i + 1) * per] for k, v in batch.items()}


def _batch_mean(tensors: list, mesh, profile: str) -> list:
    """Mean of each tensor over the ranks of the mesh's batch axes, in
    the tensor's own dtype (identity outside an initialized world)."""
    if mesh is None:
        return tensors
    n = 1
    for a in S.batch_axis_tuple(mesh, profile):
        group = mesh.group(a)
        if group is None:
            continue
        for t in tensors:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        n *= dist.get_world_size(group)
    if n > 1:
        torch._foreach_div_(tensors, float(n))
    return tensors


def make_loss_fn(cfg: ModelConfig, mesh=None, opt: Optional[OptConfig] = None,
                 profile: str = "2d"):
    """``loss_fn(params, batch)`` on this rank's slice of the batch, the
    float32 parameters cast to ``opt.gather_dtype`` before use."""
    def loss_fn(params, batch):
        if opt is not None and opt.gather_dtype:
            gd = getattr(torch, opt.gather_dtype)
            params = tree_map(
                lambda p: p.to(gd) if p.dtype == torch.float32 else p,
                params)
        return M.loss_fn(params, _local_batch(batch, mesh, profile), cfg)
    return loss_fn


def make_grad_fn(cfg: ModelConfig, opt: OptConfig, mesh=None,
                 profile: str = "2d"):
    """``grad_fn(params, batch) -> (loss, grads)``: the train step up to
    the optimizer — the global batch split into ``grad_accum``
    micro-batches (each then sliced by rank), the ``grad_dtype`` cast,
    and the mean over the batch axes.  The loss is a detached float32
    scalar."""
    loss_fn = make_loss_fn(cfg, mesh, opt, profile)

    def value_and_grad(leaves, params, batch):
        live = tree_unflatten(params, leaves)
        loss = loss_fn(live, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        k = opt.grad_accum
        if k > 1:
            b = next(iter(batch.values())).shape[0]
            if b % k:
                raise ValueError(f"batch {b} does not split into "
                                 f"{k} micro-batches")
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for j in range(k):
                mb = {n: v[j * (b // k):(j + 1) * (b // k)]
                      for n, v in batch.items()}
                l, g = value_and_grad(leaves, params, mb)
                loss = loss + l
                torch._foreach_add_(grads, list(g))
            loss = loss / k
            torch._foreach_div_(grads, float(k))
        else:
            loss, grads = value_and_grad(leaves, params, batch)
            grads = list(grads)
        if opt.grad_dtype:
            gd = getattr(torch, opt.grad_dtype)
            grads = [g.to(gd) for g in grads]
        loss, *grads = _batch_mean([loss.to(torch.float32)] + grads, mesh,
                                   profile)
        return loss, tree_unflatten(params, grads)

    return grad_fn


def make_train_step(cfg: ModelConfig, opt: OptConfig, mesh=None,
                    profile: str = "2d"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})`` with the global batch on every rank."""
    grad_fn = make_grad_fn(cfg, opt, mesh, profile)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig, s_max: int, mesh=None):
    """``prefill_step(params, batch) -> (last logits, caches)``; the mesh
    places no activation (see ``launch/mesh.py``)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return M.prefill(params, batch, cfg, s_max=s_max)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``decode_step(params, caches, batch) -> (logits, caches)``."""
    def decode_step(params, caches, batch):
        with torch.no_grad():
            return M.decode_step(params, caches, batch, cfg)
    return decode_step


def init_train_state(cfg: ModelConfig, gen: torch.Generator):
    """Seeded parameters on ``gen``'s device and their AdamW state."""
    params = M.init_params(cfg, gen)
    return params, adamw_init(params)


def abstract_train_state(cfg: ModelConfig):
    """(params, opt_state) on the ``meta`` device — no allocation."""
    params = M.abstract_params(cfg)
    return params, adamw_init(params)
