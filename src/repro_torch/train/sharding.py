"""Sharding rules: parameter, batch and cache specs over the mesh (the
JAX package's ``train/sharding.py``), as pure functions of leaf names
and shapes.

A spec is a tuple with one entry a dim: a mesh axis name, a tuple of
axis names, or None (replicated).  Mesh axes (see ``launch/mesh.py``):

* ``pod``   — data-parallel across pods; gradients cross it once a step;
* ``data``  — FSDP within a pod: parameters sharded at rest on one axis,
  the batch sharded here too;
* ``model`` — tensor parallel: attention heads / FFN hidden / MoE experts
  / vocab.

Only ``mesh.shape`` and ``mesh.axis_names`` are read, so a stand-in with
those two attributes works.  The JAX package stacks layer groups with a
leading dim that gets ``None``; the port's parameter tree lists layers,
so its specs have no such dim (the rules detect extra leading dims by
rank, as there).  :func:`placements` turns a spec into DTensor
placements on a port :class:`~repro_torch.launch.mesh.Mesh`;
:func:`shard_params`, :func:`shard_batch` and :func:`shard_caches` turn
whole trees (the same on every rank) into DTensors by those specs, each
rank keeping its own slice with no communication, and
:func:`full_tree` gathers them back.
"""
from __future__ import annotations

import math
from typing import Optional

# leaf name → spec for the *parameter's own* dims (no layer stacking).
# convention: ("fsdp", "tp") where fsdp="data", tp="model".
_RULES: dict[str, tuple] = {
    # embedding / head
    "embed": ("model", "data"),          # (V, D): vocab TP, d FSDP
    "head": ("data", "model"),           # (D, V)
    "img_proj": ("data", "model"),
    # attention
    "wq": ("data", "model"),             # (D, H·Dh): heads TP
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),             # (H·Dh, D)
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # dense mlp
    "w_gate": ("data", "model"),         # (D, F)
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),         # (F, D)
    # moe (expert dim first) — overridden by ndim check below
    "router": ("data", None),            # (D, E) router replicated on E
    # rglru
    "wx": ("data", "model"), "wg": ("data", "model"),
    "conv_k": (None, "model"), "conv_b": ("model",),
    "wa": ("model", None), "wi": ("model", None),
    "lam": ("model",),
    # rwkv
    "wr": ("data", "model"), "wgate": ("data", "model"),
    "dw_a": ("data", None), "dw_b": (None, "data"),
    "dw_bias": (None,), "u": (None, None), "mu": (None, None),
    "mu_c": (None, None),
    "ck": ("data", "model"), "cv": ("model", "data"),
    "cr": ("data", "model"),
    # norms
    "ln": (None,), "ln1": (None,), "ln2": (None,), "ln_x": (None,),
    "final_norm": (None,),
}

# MoE expert tensors: (E, D, F) / (E, F, D).  Expert-parallel over model
# when E divides the axis; otherwise hybrid: experts replicated, the
# expert FFN hidden dim tensor-parallel (granite: 40 experts on tp=16).
_MOE_3D = {
    "w_gate": (("model", "data", None), (None, "data", "model")),
    "w_up": (("model", "data", None), (None, "data", "model")),
    "w_down": (("model", None, "data"), (None, "model", "data")),
}


def _leaf_spec(name: str, leaf, moe_ctx: bool, tp: int = 1,
               fsdp: int = 0) -> tuple:
    base: Optional[tuple] = None
    shape = tuple(leaf.shape)
    if moe_ctx and name in _MOE_3D:
        ep, hybrid = _MOE_3D[name]
        n_experts = shape[-3]
        base = ep if n_experts % tp == 0 else hybrid
    elif name in _RULES:
        base = _RULES[name]
    ndim = len(shape)
    if base is None:
        base = (None,) * ndim
    extra = ndim - len(base)          # leading stacked-layer dims → None
    if extra < 0:
        base = base[-ndim:] if ndim else ()
        extra = 0
    spec = list((None,) * extra + tuple(base))
    # drop any axis that doesn't divide the dim (vocab remainders etc.)
    for i, (dim, ax) in enumerate(zip(shape, spec)):
        if ax == "model" and dim % tp != 0:
            spec[i] = None
        if ax == "data" and fsdp and dim % fsdp != 0:
            spec[i] = None
    return tuple(spec)


def _zero3_spec(leaf, n_total: int) -> tuple:
    """ZeRO-3 profile: shard the largest divisible dim over ALL mesh
    axes combined; everything else replicated.  No tensor parallelism —
    the right scheme for small-dense models where TP all-reduces dwarf
    the matmuls."""
    shape = tuple(leaf.shape)
    if not shape:
        return ()
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % n_total == 0:
            spec = [None] * len(shape)
            spec[i] = "__all__"        # resolved to the caller's axis tuple
            return tuple(spec)
    return (None,) * len(shape)


def _with_pod_fsdp(spec: tuple, mesh) -> tuple:
    """Map the FSDP axis "data" → ("pod", "data"): parameters shard
    across pods too, halving at-rest parameter and optimizer memory a
    pod at the cost of cross-pod gathers."""
    if "pod" not in mesh.axis_names:
        return spec
    return tuple(("pod", "data") if ax == "data" else ax for ax in spec)


def _walk(node, fn, name: str = "", moe_ctx: bool = False):
    """Specs over the tree: ``fn(name, leaf, moe_ctx)`` at each leaf,
    where ``name`` is the leaf's dict key and a dict holding a ``router``
    marks a MoE block (its expert tensors take the expert rules)."""
    if isinstance(node, dict):
        is_moe = "router" in node
        return {k: _walk(v, fn, k, is_moe or moe_ctx)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, fn, name, moe_ctx) for v in node)
    return fn(name, node, moe_ctx)


def param_specs(params, mesh=None, profile: str = "2d"):
    """Spec tree matching ``params`` (works on ``meta`` tensors and any
    leaf with a ``shape``).

    ``profile="zero3"``: ignore the TP rules and shard every parameter
    over all mesh axes combined (pure FSDP / ZeRO-3).
    ``profile="2d_podfsdp"``: the 2d rules with "data" widened to
    ("pod", "data")."""
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    fsdp = mesh.shape.get("data", 1) if mesh is not None else 1

    if profile == "zero3":
        axes = tuple(mesh.axis_names)
        n_total = math.prod(mesh.shape[a] for a in axes)

        def z(name, leaf, moe_ctx):
            return tuple(axes if s == "__all__" else s
                         for s in _zero3_spec(leaf, n_total))
        return _walk(params, z)

    pod = mesh.shape.get("pod", 1) if mesh is not None else 1

    def two_d(name, leaf, moe_ctx):
        spec = _leaf_spec(name, leaf, moe_ctx, tp=tp,
                          fsdp=fsdp * pod if profile == "2d_podfsdp"
                          else fsdp)
        if profile == "2d_podfsdp" and mesh is not None:
            spec = _with_pod_fsdp(spec, mesh)
        return spec

    return _walk(params, two_d)


def batch_axes(mesh, profile: str = "2d"):
    """The mesh-axis name(s) the batch dim shards over (pod × data;
    zero3: every axis — the whole mesh is data-parallel)."""
    if profile == "zero3":
        return tuple(mesh.axis_names)
    axes = tuple(n for n in mesh.axis_names if n in ("pod", "data"))
    return axes if len(axes) > 1 else axes[0]


def batch_axis_tuple(mesh, profile: str = "2d") -> tuple:
    """:func:`batch_axes` as a tuple of axis names."""
    ba = batch_axes(mesh, profile)
    return ba if isinstance(ba, tuple) else (ba,)


def cache_specs(caches: list, mesh) -> list:
    """The JAX package's ``cache_shardings`` as specs, one per layer of
    the port's cache list (no leading layer-stack dim): batch
    over (pod, data) unless the batch does not tile them, KV heads (or
    the head dim, for one kv head) and channels over ``model``."""
    from ..models import blocks as B
    ba = batch_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in batch_axis_tuple(mesh))
    tp = mesh.shape.get("model", 1)

    def one(c):
        bs = ba if c[0].shape[0] % n_data == 0 else None
        if isinstance(c, B.AttnCache):
            kv, dh = c.k.shape[-2], c.k.shape[-1]
            if kv % tp == 0:            # GQA: shard KV heads
                kspec = (None, "model", None)
            elif dh % tp == 0:          # MQA: shard head_dim instead
                kspec = (None, None, "model")
            else:
                kspec = (None, None, None)
            return B.AttnCache(k=(bs, *kspec), v=(bs, *kspec),
                               pos=(bs, None), index=())
        if isinstance(c, B.RGLRUCache):
            return B.RGLRUCache(h=(bs, "model"), conv=(bs, None, "model"))
        if isinstance(c, B.RWKVCache):
            return B.RWKVCache(wkv=(bs, "model", None, None),
                               shift1=(bs, None), shift2=(bs, None))
        raise TypeError(type(c))

    return [one(c) for c in caches]


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``: for each mesh axis,
    ``Shard(d)`` where dim d's entry names that axis, else
    ``Replicate()``.  A dim sharded over several axes splits in the
    mesh's axis order."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == axis or (isinstance(ax, tuple) and axis in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_tensor(t, spec: tuple, mesh):
    """``t`` (the whole tensor, equal on every rank) as a DTensor over
    ``mesh`` with ``spec``'s placements: each rank keeps its slice (a
    copy, so the whole tensor can be freed), with no communication.  A
    dim sharded over several axes splits in the mesh's axis order, as
    DTensor lays it out; the rules keep only axes that divide their
    dims."""
    import torch
    from torch.distributed.tensor import DTensor
    if mesh.device_mesh is None:
        raise ValueError("shard_tensor needs a mesh over an initialized "
                         "torch.distributed world")
    pls = placements(spec, mesh)
    local = t
    for axis, pl in zip(mesh.axis_names, pls):
        if pl.is_shard():
            n = mesh.shape[axis]
            size = local.shape[pl.dim] // n
            local = local.narrow(pl.dim, mesh.index(axis) * size, size)
    if local is not t:
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh.device_mesh, pls, run_check=False,
                              shape=t.shape, stride=t.stride())


def shard_like(tree, specs, mesh):
    """``tree`` as DTensors placed by ``specs``, a spec tree of its
    shape (a subtree of :func:`param_specs` of a tree it is part of)."""
    from ..tree import leaves_at, tree_leaves, tree_unflatten
    return tree_unflatten(tree, [
        shard_tensor(p, s, mesh)
        for p, s in zip(tree_leaves(tree), leaves_at(specs, tree))])


def shard_params(params, mesh, profile: str = "2d"):
    """``params`` (or any tree shaped like them, e.g. AdamW moments) as
    DTensors placed by :func:`param_specs`."""
    return shard_like(params, param_specs(params, mesh, profile), mesh)


def batch_spec(x, mesh, profile: str = "2d") -> tuple:
    """The batch dim over :func:`batch_axes`, or replicated where the
    batch does not tile them (the JAX package's ``batch_shardings``)."""
    axes = batch_axis_tuple(mesh, profile)
    n = math.prod(mesh.shape[a] for a in axes)
    ba = batch_axes(mesh, profile)
    return ((ba if x.shape[0] % n == 0 else None),) + \
        (None,) * (len(x.shape) - 1)


def shard_batch(batch: dict, mesh, profile: str = "2d") -> dict:
    """A global batch (equal on every rank) as DTensors sharded over the
    batch axes."""
    return {k: shard_tensor(v, batch_spec(v, mesh, profile), mesh)
            for k, v in batch.items()}


def shard_caches(caches: list, mesh) -> list:
    """Decode caches as DTensors placed by :func:`cache_specs` (integer
    fields stay as they are)."""
    out = []
    for c, spec in zip(caches, cache_specs(caches, mesh)):
        out.append(type(c)(*[shard_tensor(f, s, mesh) if hasattr(f, "shape")
                             else f for f, s in zip(c, spec)]))
    return out


def full_tree(tree):
    """Every DTensor leaf of ``tree`` gathered whole (a collective: every
    rank calls it); other leaves as they are."""
    from torch.distributed.tensor import DTensor
    from ..tree import tree_map
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)
