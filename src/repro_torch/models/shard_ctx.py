"""Activation-sharding context: model code asks, the trainer provides
(the JAX package's ``models/shard_ctx.py`` on DTensors).

Model code is mesh-agnostic; the train, prefill and decode steps install
an ``activation_sharding(mesh)`` context and layers call
``constrain(x, ...)`` with *logical* axes:

* ``"batch"`` → all data-parallel mesh axes (pod, data); every axis
  under the ``zero3`` profile,
* ``"model"`` → the tensor-parallel axis (dropped where the dim does not
  divide the axis size, e.g. kv=8 heads on model=16; dropped everywhere
  under ``zero3``),
* ``None``    → replicated.

``constrain`` redistributes a DTensor to the placements of that spec
(``train.sharding.placements``), and places its gradient the same way,
as JAX transposes a sharding constraint.  It returns a plain tensor, or
any tensor with no context installed, as it is, so every single-device
path is unchanged.

The sharded train step also installs a parameter gather
(:func:`param_gather`): the model passes each layer's parameters through
:func:`gathered` where it uses them, inside the layer's remat boundary,
so the FSDP all-gather happens a layer at a time and is replayed by the
recompute, as XLA schedules it in the JAX package.

A counter of programs on ``meta`` tensors (``launch.census``) may
install a repeat hook (:func:`count_repeats`): :func:`alike_steps` then
runs one step of a loop whose steps are alike and counts it for all.

The state is module-global, not thread-local: the recompute of a
checkpointed layer runs on autograd's device thread, which must see the
same context as the forward.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

_STATE = {"mesh": None, "profile": "2d", "gather": None, "repeat": None}


@contextlib.contextmanager
def activation_sharding(mesh, profile: str = "2d"):
    prev = (_STATE["mesh"], _STATE["profile"])
    _STATE["mesh"], _STATE["profile"] = mesh, profile
    try:
        yield
    finally:
        _STATE["mesh"], _STATE["profile"] = prev


@contextlib.contextmanager
def count_repeats(hook: Optional[Callable]):
    """Install ``hook(n)``, a context manager under which a counter
    counts what runs ``n`` times, for :func:`alike_steps`."""
    prev = _STATE["repeat"]
    _STATE["repeat"] = hook
    try:
        yield
    finally:
        _STATE["repeat"] = prev


def alike_steps(lo: int, hi: int, like):
    """``range(lo, hi)`` for a loop whose steps have the same shapes and
    work and keep nothing of a step but the carry.  On ``meta`` tensors
    (``like``), where there are no values, outside autograd and under a
    repeat hook, the first step runs once inside ``hook(hi - lo)``: the
    counts are those of every step and the live memory is one step's,
    as in the whole loop."""
    hook = _STATE["repeat"]
    if (hook is None or hi - lo <= 1 or like.device.type != "meta"
            or torch.is_grad_enabled()):
        yield from range(lo, hi)
        return
    with hook(hi - lo):
        yield lo


def current_mesh():
    return _STATE["mesh"]


def current_profile() -> str:
    return _STATE["profile"]


@contextlib.contextmanager
def param_gather(fn: Optional[Callable]):
    """Install ``fn`` (a parameter subtree → the subtree as used) for
    :func:`gathered`."""
    prev = _STATE["gather"]
    _STATE["gather"] = fn
    try:
        yield
    finally:
        _STATE["gather"] = prev


def gathered(tree):
    """``tree`` (a layer's parameters, or one parameter) as the model
    uses it: through the installed gather, else as it is."""
    fn = _STATE["gather"]
    return tree if fn is None else fn(tree)


def logical_spec(shape, *logical, mesh=None, profile: Optional[str] = None
                 ) -> tuple:
    """The spec (one entry a dim: an axis name, a tuple of them, or None)
    that ``constrain`` pins a tensor of ``shape`` to, by the JAX
    package's rules."""
    mesh = current_mesh() if mesh is None else mesh
    profile = current_profile() if profile is None else profile
    assert len(logical) == len(shape), (logical, tuple(shape))
    if profile == "zero3":
        batch_axes = tuple(mesh.axis_names)
        logical = tuple(None if ax == "model" else ax for ax in logical)
    else:
        batch_axes = tuple(n for n in mesh.axis_names if n in ("pod", "data"))
    if len(batch_axes) == 1:
        batch_axes = batch_axes[0]
    spec = []
    for dim, ax in zip(shape, logical):
        if ax == "batch":
            n = 1
            for a in (batch_axes if isinstance(batch_axes, tuple)
                      else (batch_axes,)):
                n *= mesh.shape[a]
            spec.append(batch_axes if dim % n == 0 else None)
        elif ax == "model":
            tp = mesh.shape.get("model", 1)
            spec.append("model" if dim % tp == 0 else None)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, *logical):
    """Redistribute a DTensor ``x`` to the placements of its logical
    spec when a mesh context is active, its gradient placed the same way
    (:class:`_PinGrad`); anything else as it is."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from ..train.sharding import placements
    want = placements(logical_spec(x.shape, *logical), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return _PinGrad.apply(x) if x.requires_grad else x


class _PinGrad(torch.autograd.Function):
    """Identity forward; the backward places the gradient as the forward
    value is placed (JAX transposes a sharding constraint into the same
    constraint on the cotangent).  Without it a partial sum over model
    flows back through a replicated activation, and DTensor gathers the
    sharded operands of the products behind it instead of reducing it."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def pinned(t, *logical):
    """A tensor the model makes itself (a zero state, an accumulator),
    under a context over a world: a DTensor placed by its logical spec,
    so it meets sharded activations with matching placements; anything
    else as it is."""
    mesh = current_mesh()
    if mesh is None or getattr(mesh, "device_mesh", None) is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh.device_mesh,
                               [Replicate()] * len(mesh.axis_names),
                               run_check=False)
    return constrain(t, *logical)


def run_local(fn, in_logical, out_like, *args):
    """``fn(*args)`` on each rank's shards: under a context over a world,
    every tensor argument is pinned to its logical spec (``in_logical``,
    one tuple an argument; None leaves it as it is) and taken local, and
    output j is placed back as argument ``out_like[j]`` is (same rank,
    same sharded dims).  For work that is independent along the sharded
    dims (a recurrence per sequence and head) and that DTensor's rules
    cannot follow through its reshapes; XLA partitions the same work
    along those dims without collectives.  Else ``fn(*args)``."""
    mesh = current_mesh()
    if mesh is None or getattr(mesh, "device_mesh", None) is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    placed = [a if lg is None else pinned(a, *lg)
              for a, lg in zip(args, in_logical)]
    # an argument replicated along a mesh axis that another argument is
    # sharded on gets a partial gradient there: each rank's shards
    # contribute their part
    from torch.distributed.tensor import Partial
    split = [any(isinstance(a, DTensor) and a.placements[d].is_shard()
                 for a in placed) for d in range(len(mesh.axis_names))]
    local = [_local(a, [Partial() if split[d] and p.is_replicate() else p
                        for d, p in enumerate(a.placements)])
             if isinstance(a, DTensor) else a for a in placed]
    # fn works on plain shards: no context inside it
    _STATE["mesh"] = None
    try:
        outs = fn(*local)
    finally:
        _STATE["mesh"] = mesh
    return tuple(DTensor.from_local(o, mesh.device_mesh,
                                    placed[i].placements, run_check=False)
                 for o, i in zip(outs, out_like))


def tp_out(x):
    """The output of a tensor-parallel contraction (the JAX package's
    ``"tp_out"`` name): pinned batch-sharded and replicated over model,
    so its all-reduce runs here, where the ``block_save_coll`` remat
    policy sees it and keeps its output.  Its gradient is replicated over
    model too, so both backward products of the contraction (weight and
    input gradient) run on the rank's shards."""
    return constrain(x, "batch", *(None,) * (x.ndim - 1))


def _local(x, grad_placements=None):
    """A DTensor's local tensor whose gradient is made contiguous before
    it is placed back (DTensor derives the global stride from the local
    gradient's, and a permuted one reads as another sharding), with
    ``grad_placements`` (default: ``x``'s own)."""
    import torch

    class _ContiguousGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return g.contiguous()

    return _ContiguousGrad.apply(x.to_local(grad_placements=grad_placements))


def partial_over(local, like, md: int):
    """``local`` (this rank's partial values) as a DTensor on ``like``'s
    mesh: ``Partial`` along mesh dim ``md``, ``like``'s placements
    elsewhere.  Its gradient comes back replicated along ``md``, whole
    to every rank's ``local`` (a vocab-parallel lookup's rows)."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate

    class _PartialFromLocal(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            pls = list(like.placements)
            pls[md] = Partial()
            ctx.grad_pls = list(like.placements)
            ctx.grad_pls[md] = Replicate()
            return DTensor.from_local(t, like.device_mesh, pls,
                                      run_check=False)

        @staticmethod
        def backward(ctx, g):
            return g.redistribute(g.device_mesh, ctx.grad_pls).to_local()

    return _PartialFromLocal.apply(local)


def local_rows(x):
    """This rank's sequences of a batch-leading tensor: a DTensor pinned
    batch-sharded (replicated over every other axis) and its local
    tensor taken; anything else as it is.  For per-sequence work that
    DTensor has no rules for (MoE routing)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _local(constrain(x, "batch", *(None,) * (x.ndim - 1)))


def rows_like(local, like):
    """``local`` (this rank's sequences) placed as ``like``'s batch rows
    are, where ``like`` is a batch-sharded DTensor; else as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor):
        return local
    like = constrain(like, "batch", *(None,) * (like.ndim - 1))
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False)


def split_heads(t, n: int, dh: int):
    """(B, S, n·dh) → (B, S, n, dh) pinned ("batch", None, "model",
    None).  A projection sharded over model is replicated first where n
    does not divide the axis (DTensor cannot split a dim sharded
    unevenly; the heads are replicated then, as the rule says)."""
    mesh = current_mesh()
    if mesh is not None and n % mesh.shape.get("model", 1):
        t = constrain(t, "batch", None, None)
    return constrain(t.reshape(*t.shape[:2], n, dh),
                     "batch", None, "model", None)


def merge_heads(t):
    """(B, S, n, dh) → (B, S, n·dh), the input of a row-parallel output
    projection.  Where n does not divide the model axis it is pinned
    replicated: the product's input gradient comes back sharded over
    n·dh, which DTensor cannot split back into n heads (the mirror of
    :func:`split_heads`)."""
    out = t.reshape(*t.shape[:2], -1)
    mesh = current_mesh()
    if mesh is not None and t.shape[2] % mesh.shape.get("model", 1):
        out = constrain(out, "batch", None, None)
    return out


def constrain_heads(x):
    """(B, S, H, Dh): shard H over model if divisible, else shard Dh —
    replicated heads cost tp× attention flops."""
    mesh = current_mesh()
    if mesh is None:
        return x
    tp = mesh.shape.get("model", 1)
    h, dh = x.shape[-2], x.shape[-1]
    if h % tp == 0:
        return constrain(x, "batch", None, "model", None)
    if dh % tp == 0:
        return constrain(x, "batch", None, None, "model")
    return constrain(x, "batch", None, None, None)
