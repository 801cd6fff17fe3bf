"""Train-step and serve-step factories (the JAX package's
``train/trainer.py``).

``make_train_step`` builds the update: loss → gradients (``grad_accum``
micro-batches, their mean) → optional ``grad_dtype`` cast → AdamW, in
place on the state (donated, as in the JAX package).

With a mesh of an initialized world the step is the JAX package's
FSDP×TP step: a plain state is first placed by
``train.sharding.shard_params`` (its DTensors are returned), and
parameters and AdamW moments stay sharded at rest.  Each layer's
parameters are cast to ``gather_dtype`` on the local shard and
all-gathered over the FSDP axes where the layer uses them
(``shard_ctx.gathered``, inside the remat boundary, so the recompute
gathers again), kept sharded over ``model``; activations are pinned by
``shard_ctx.constrain`` as in the JAX package.  The gather's backward
reduce-scatters each gradient to its parameter's placements as the
backward reaches it (in ``grad_dtype`` where set), so no rank holds a
whole gradient of a sharded leaf; micro-batches sum the local shards.
The global batch (equal on every rank) is sharded over the batch axes;
the loss is the whole batch's mean.  ``mesh=None`` and a mesh outside a
world run the step on one process with plain tensors.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..models import model as M
from ..models.config import ModelConfig
from ..models.shard_ctx import activation_sharding, param_gather
from ..tree import tree_leaves, tree_map, tree_unflatten
from . import sharding as S
from .optimizer import OptConfig, adamw_init, adamw_update


def is_sharded(params) -> bool:
    """True when the state is DTensors (the sharded step's)."""
    return any(isinstance(p, DTensor) for p in tree_leaves(params))


class _GradCast(torch.autograd.Function):
    """Identity forward; the backward casts the gradient's local values
    to ``dtype`` (placements kept), so the reduction after it moves that
    dtype."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            return DTensor.from_local(
                g.to_local().to(ctx.dtype), g.device_mesh, g.placements,
                run_check=False, shape=g.shape, stride=g.stride()), None
        return g.to(ctx.dtype), None


def gather_fn(mesh, profile: str = "2d", opt: Optional[OptConfig] = None):
    """The sharded step's parameter gather (``shard_ctx.param_gather``):
    each DTensor leaf cast to ``opt.gather_dtype`` on its shard, then
    all-gathered over every axis but ``model`` (every axis under
    ``zero3``); with ``opt.grad_dtype`` its gradient is cast before the
    gather's backward reduce-scatters it."""
    gd = getattr(torch, opt.gather_dtype) if opt and opt.gather_dtype \
        else None
    rd = getattr(torch, opt.grad_dtype) if opt and opt.grad_dtype else None

    def one(p):
        if not isinstance(p, DTensor):
            return p
        if gd is not None and p.dtype == torch.float32:
            p = p.to(gd)
        want = tuple(pl if axis == "model" and profile != "zero3"
                     else Replicate()
                     for axis, pl in zip(mesh.axis_names, p.placements))
        if want != tuple(p.placements):
            p = p.redistribute(p.device_mesh, want)
        if rd is not None and p.requires_grad:
            p = _GradCast.apply(p, rd)
        return p

    return lambda tree: tree_map(one, tree)


@contextlib.contextmanager
def sharded_context(mesh, profile: str = "2d",
                    opt: Optional[OptConfig] = None):
    """The contexts a sharded step runs the model under: activation
    constraints, the parameter gather, and plain tensors made inside the
    model (positions, masks, accumulators) taken as replicated."""
    with activation_sharding(mesh, profile), \
            param_gather(gather_fn(mesh, profile, opt)), \
            implicit_replication():
        yield


def in_world(mesh) -> bool:
    """True for a mesh over an initialized world (the sharded step's)."""
    return mesh is not None and mesh.device_mesh is not None


def place_state(params, opt_state, mesh, profile: str = "2d"):
    """A plain (params, AdamW state) placed over ``mesh`` by
    ``shard_params``; a sharded one, or one outside a world, as it
    is."""
    if not in_world(mesh) or is_sharded(params):
        return params, opt_state
    return (S.shard_params(params, mesh, profile),
            dict(opt_state, m=S.shard_params(opt_state["m"], mesh, profile),
                 v=S.shard_params(opt_state["v"], mesh, profile)))


def _sharded_loss(cfg, params, batch, mesh, profile):
    """The whole batch's loss as a plain (replicated) scalar, the batch
    sharded over the batch axes; run under :func:`sharded_context`."""
    loss = M.loss_fn(params, S.shard_batch(batch, mesh, profile), cfg)
    return loss.full_tensor() if isinstance(loss, DTensor) else loss


def make_loss_fn(cfg: ModelConfig, mesh=None, opt: Optional[OptConfig] = None,
                 profile: str = "2d"):
    """``loss_fn(params, batch)``: the whole batch's loss, the float32
    parameters cast to ``opt.gather_dtype`` before use.  In a world the
    state is placed by :func:`place_state`, the batch sharded and the
    model run under :func:`sharded_context`; the loss is a plain
    replicated scalar."""
    def loss_fn(params, batch):
        if in_world(mesh):
            if not is_sharded(params):
                params = S.shard_params(params, mesh, profile)
            with sharded_context(mesh, profile, opt):
                return _sharded_loss(cfg, params, batch, mesh, profile)
        if opt is not None and opt.gather_dtype:
            gd = getattr(torch, opt.gather_dtype)
            params = tree_map(
                lambda p: p.to(gd) if p.dtype == torch.float32 else p,
                params)
        return M.loss_fn(params, batch, cfg)
    return loss_fn


def make_grad_fn(cfg: ModelConfig, opt: OptConfig, mesh=None,
                 profile: str = "2d"):
    """``grad_fn(params, batch) -> (loss, grads)``: the train step up to
    the optimizer — the global batch split into ``grad_accum``
    micro-batches and the ``grad_dtype`` cast; in a world the gradients
    are DTensors placed as their parameters (a plain ``params`` is
    placed first).  The loss is a detached float32 scalar."""
    loss_fn = make_loss_fn(cfg, mesh, opt, profile)

    def value_and_grad(leaves, params, batch):
        live = tree_unflatten(params, leaves)
        if not is_sharded(params):
            loss = loss_fn(live, batch)
            return loss.detach(), torch.autograd.grad(loss, leaves)
        # one context over the forward and the backward (whose remat
        # recompute runs the model again)
        with sharded_context(mesh, profile, opt):
            loss = _sharded_loss(cfg, live, batch, mesh, profile)
            grads = torch.autograd.grad(loss, leaves)
        # a leaf used replicated gets a partial gradient: reduce it to
        # the leaf's placements (reduce-scatter / all-reduce)
        grads = [g if tuple(g.placements) == tuple(p.placements)
                 else g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(grads, leaves)]
        return loss.detach(), tuple(g.to_local() for g in grads)

    def grad_fn(params, batch):
        if in_world(mesh) and not is_sharded(params):
            params = S.shard_params(params, mesh, profile)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        sharded = is_sharded(params)
        k = opt.grad_accum
        if k > 1:
            b = next(iter(batch.values())).shape[0]
            if b % k:
                raise ValueError(f"batch {b} does not split into "
                                 f"{k} micro-batches")
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros(g.shape, dtype=torch.float32,
                                 device=g.device)
                     for g in (p.to_local() if sharded else p
                               for p in leaves)]
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
        if sharded:
            # already reduced over the mesh by the gathers' backward
            grads = [DTensor.from_local(g, p.device_mesh, p.placements,
                                        run_check=False, shape=p.shape,
                                        stride=p.stride())
                     for g, p in zip(grads, leaves)]
        return loss.to(torch.float32), tree_unflatten(params, grads)

    return grad_fn


def make_train_step(cfg: ModelConfig, opt: OptConfig, mesh=None,
                    profile: str = "2d"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})`` with the global batch on every rank.  The
    state is updated in place (donated) and returned; in a world a plain
    state is placed first (:func:`place_state`)."""
    grad_fn = make_grad_fn(cfg, opt, mesh, profile)

    def train_step(params, opt_state, batch):
        params, opt_state = place_state(params, opt_state, mesh, profile)
        loss, grads = grad_fn(params, batch)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _serve_context(mesh, params):
    """Activation constraints over ``mesh``; with DTensor parameters
    also their gather and implicit replication, as in the train step."""
    if mesh is not None and is_sharded(params):
        return sharded_context(mesh)
    return activation_sharding(mesh)


def make_prefill_step(cfg: ModelConfig, s_max: int, mesh=None):
    """``prefill_step(params, batch) -> (last logits, caches)`` under
    ``activation_sharding(mesh)``, as in the JAX package."""
    def prefill_step(params, batch):
        with torch.no_grad(), _serve_context(mesh, params):
            return M.prefill(params, batch, cfg, s_max=s_max)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``decode_step(params, caches, batch) -> (logits, caches)`` under
    ``activation_sharding(mesh)``."""
    def decode_step(params, caches, batch):
        with torch.no_grad(), _serve_context(mesh, params):
            return M.decode_step(params, caches, batch, cfg)
    return decode_step


def init_train_state(cfg: ModelConfig, gen: torch.Generator, mesh=None,
                     profile: str = "2d"):
    """Seeded parameters on ``gen``'s device and their AdamW state.  Over
    a mesh of a world each rank keeps its shards by ``param_specs``, each
    layer sliced as it is made: no rank holds the whole float32 tree,
    and the values are those of ``shard_params`` of the whole."""
    place = None
    if in_world(mesh):
        specs = S.param_specs(M.abstract_params(cfg), mesh, profile)

        def place(path, sub):
            spec = specs
            for k in path:
                spec = spec[k]
            return S.shard_like(sub, spec, mesh)
    params = M.init_params(cfg, gen, place)
    return params, adamw_init(params)


def abstract_train_state(cfg: ModelConfig):
    """(params, opt_state) on the ``meta`` device — no allocation."""
    params = M.abstract_params(cfg)
    return params, adamw_init(params)
