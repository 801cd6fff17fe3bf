"""Collective bytes, op census, FLOPs and live memory of a PyTorch
program (the JAX package's ``launch/hlo.py``; there is no HLO to parse).

:class:`Census` is a ``TorchDispatchMode`` that sees every op the
program dispatches *below* DTensor: an op on DTensors is handed on
(``NotImplemented``) so DTensor lowers it to its local ops and
collectives, which the mode then sees on each rank's shards.  It counts:

* **collectives** — the functional collectives DTensor and
  ``torch.distributed._functional_collectives`` issue
  (``_c10d_functional.*``) and the c10d ops of explicit ``dist.*``
  calls (``c10d.allreduce_`` and its kin), each once: the
  ``wait_tensor`` that completes a functional collective carries no
  payload and is not counted.  :meth:`Census.collective_bytes` sums
  *operand* bytes per kind under the JAX package's five names plus
  ``"total"``, listing the kinds that occur, as ``hlo.collective_bytes``
  does.  On a CPU process group DTensor lowers all-to-all to an
  all-gather and a chunk, so a MoE program counted there shows
  all-gather bytes where a NCCL one shows all-to-all.
* **ops** — :meth:`Census.op_census` counts dispatched aten ops under
  the JAX names where one exists (``dot``: mm, bmm, addmm, baddbmm, dot;
  ``scatter``, ``gather``, ``transpose``, ``reshape``, ``copy``);
  ``fusion`` and ``while`` are XLA constructs with no eager
  counterpart and are reported as None.
* **FLOPs** — each op's count by ``torch.utils.flop_counter``'s
  formulas on the local shapes (per device; matmul-class ops and
  convolutions only, where XLA's cost analysis counts every op).
* **bytes accessed** — each non-view op's input and output bytes, as
  if nothing were fused (an upper bound on HBM traffic).
* **live memory** — the bytes of storages allocated while the mode is
  on and still alive (a finalizer on each storage), and their peak;
  storages passed to :meth:`Census.pin` (the program's arguments) are
  not counted.

Inside :meth:`Census.repeat` (installed as the model's repeat hook,
``models.shard_ctx.alike_steps``) every count but live memory is
multiplied: one step of a loop of alike steps on ``meta`` tensors counts
for all of them.

DTensor infers each new op's global output shape by running the op on
global-shaped fake tensors (its sharding propagation, on a cache miss);
those runs are not the program's and are not counted
(:attr:`Census.excludes_propagation` says whether this torch exposes the
hook that tells them apart).

``CommDebugMode`` counts collectives by operation only; it is a
cross-check, not the byte source.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..models.shard_ctx import count_repeats

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name -> (kind, index of the operand argument)
_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
}
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}
_NAMESPACES = {"_c10d_functional": _FUNCTIONAL,
               "_c10d_functional_autograd": _FUNCTIONAL, "c10d": _C10D}

OPS = ("fusion", "dot", "scatter", "gather", "transpose", "reshape", "copy",
       "while")
_OP_NAMES = {
    "dot": ("mm", "bmm", "addmm", "baddbmm", "dot", "addbmm"),
    "scatter": ("scatter", "scatter_", "scatter_add", "scatter_add_",
                "index_put", "index_put_", "index_copy", "index_copy_",
                "index_add", "index_add_", "scatter_reduce"),
    "gather": ("gather", "index_select", "embedding", "index",
               "take_along_dim"),
    "transpose": ("transpose", "t", "permute", "transpose_"),
    "reshape": ("view", "reshape", "_unsafe_view", "_reshape_alias",
                "expand", "squeeze", "unsqueeze", "flatten"),
    "copy": ("copy_", "_to_copy", "clone", "contiguous"),
}
_OP_KIND = {name: kind for kind, names in _OP_NAMES.items()
            for name in names}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def collective_kind(func) -> Optional[tuple]:
    """(kind, operand index) of a collective op, or None."""
    ns = getattr(func, "namespace", None)
    table = _NAMESPACES.get(ns)
    if table is None:
        return None
    return table.get(func._schema.name.split("::")[-1])


_PROPAGATION = "_propagate_tensor_meta_non_cached"
_DEVICE = torch.ops.prim.device.default


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, type) and issubclass(t, DTensor)


class Census(TorchDispatchMode):
    """Counts what a program dispatches below DTensor (see the module
    docstring).  Use as a context manager around the program."""

    def __init__(self, track_memory: bool = True):
        super().__init__()
        self.coll: Dict[str, int] = defaultdict(int)
        self.coll_calls: Dict[str, int] = defaultdict(int)
        self.ops: Dict[str, int] = defaultdict(int)
        self.flops = 0
        self.bytes_accessed = 0
        self.track_memory = track_memory
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}
        self._pinned: set = set()
        self._in_propagation = 0
        self._restore = None
        self._repeats = None
        self._scale = 1
        self.excludes_propagation = False

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs inside ``n`` times (not live memory)."""
        prev = self._scale
        self._scale = prev * n
        try:
            yield
        finally:
            self._scale = prev

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = getattr(ShardingPropagator, _PROPAGATION, None)
        if orig is not None:
            census = self

            def propagate(prop, *args, **kwargs):
                census._in_propagation += 1
                try:
                    return orig(prop, *args, **kwargs)
                finally:
                    census._in_propagation -= 1
            setattr(ShardingPropagator, _PROPAGATION, propagate)
            self._restore = (ShardingPropagator, orig)
            self.excludes_propagation = True
        self._repeats = count_repeats(self.repeat)
        self._repeats.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self._repeats.__exit__(None, None, None)
        if self._restore is not None:
            cls, orig = self._restore
            setattr(cls, _PROPAGATION, orig)
            self._restore = None
        return super().__exit__(*exc)

    # -- memory --------------------------------------------------------
    @staticmethod
    def _key(t: torch.Tensor) -> Optional[int]:
        try:
            return t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return None

    def pin(self, tree) -> int:
        """Exclude the storages of ``tree``'s tensors (the arguments)
        from live memory; returns their bytes, each storage once."""
        from torch.distributed.tensor import DTensor
        total = 0
        for x in tree_flatten(tree)[0]:
            if isinstance(x, DTensor):
                x = x.to_local()
            if isinstance(x, torch.Tensor):
                k = self._key(x)
                if k is not None and k not in self._pinned:
                    self._pinned.add(k)
                    total += x.untyped_storage().nbytes()
        return total

    def is_pinned(self, t: torch.Tensor) -> bool:
        return self._key(t) in self._pinned

    def _freed(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            k = self._key(t)
            if k is None or k in self._seen or k in self._pinned:
                continue
            s = t.untyped_storage()
            n = s.nbytes()
            self._seen[k] = n
            self.live += n
            weakref.finalize(s, self._freed, k)
        self.peak = max(self.peak, self.live)

    # -- dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        if func is _DEVICE:                 # a metadata query
            return func(*args, **(kwargs or {}))
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._in_propagation:
            return out
        coll = collective_kind(func)
        if coll is not None:
            kind, i = coll
            self.coll[kind] += _tensor_bytes(args[i]) * self._scale
            self.coll_calls[kind] += self._scale
            return out
        name = func._schema.name.split("::")[-1]
        kind = _OP_KIND.get(name)
        if kind is not None:
            self.ops[kind] += self._scale
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out)) \
                * self._scale
        if not func.is_view:
            self.bytes_accessed += (_tensor_bytes(
                [a for a in tree_flatten((args, kwargs))[0]
                 if isinstance(a, torch.Tensor)]) + _tensor_bytes(
                [o for o in tree_flatten(out)[0]
                 if isinstance(o, torch.Tensor)])) * self._scale
        if self.track_memory:
            self._track(out)
        return out

    # -- results -------------------------------------------------------
    def collective_bytes(self) -> Dict[str, int]:
        """Operand bytes per collective kind that occurred, plus
        ``"total"`` (the JAX package's ``hlo.collective_bytes``)."""
        out = {k: int(self.coll[k]) for k in COLLECTIVES if k in self.coll}
        out["total"] = sum(out.values())
        return out

    def op_census(self) -> Dict[str, Optional[int]]:
        """Dispatched ops under the JAX names (``fusion``/``while``:
        None, no eager counterpart)."""
        return {op: (None if op in ("fusion", "while")
                     else int(self.ops.get(op, 0))) for op in OPS}
