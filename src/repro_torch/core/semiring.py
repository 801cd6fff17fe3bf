"""Semiring algebra for associative arrays.

D4M associative arrays take values in a semiring (S, ⊕, ⊗, 0, 1).  The
classic examples used in the paper's analytics are:

* ``plus_times``  — ordinary sparse linear algebra (graph construction,
  degree computation, correlation: E'*E).
* ``min_plus`` / ``max_plus`` — shortest/longest path relaxations.
* ``max_min``    — bottleneck capacities.
* ``or_and``     — boolean reachability (logical adjacency).
* ``max_times``  — Viterbi-style products.

Each semiring carries the torch element-wise combine (``mul``), the
segment reduction used to contract an axis (``reduce``), and the
identities.  The sparse routines in :mod:`repro_torch.core.sparse` are
generic over this object, so SpMV/SpMM/degree all work for every
semiring.

``reduce`` keeps the JAX segment-reduction contract the reference is
written against: empty segments of a max (min) reduction hold -inf
(+inf) — not the semiring's ``zero`` — and segment ids outside
``[0, num_segments)`` are dropped.  The in-place coalesce parks dead
slots at ``row == num_segments`` and relies on that drop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor


def segment_reduce(data: Tensor, segment_ids: Tensor, num_segments: int,
                   op: str) -> Tensor:
    """``out[s] = op over {data[i] : segment_ids[i] == s}`` along dim 0.

    ``op`` is ``"sum"``, ``"amax"`` or ``"amin"``.  Ids outside
    ``[0, num_segments)`` go to one extra segment that is sliced off.
    """
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                      torch.full_like(ids, num_segments))
    shape = (num_segments + 1,) + tuple(data.shape[1:])
    if op == "sum":
        out = torch.zeros(shape, dtype=data.dtype, device=data.device)
        out.index_add_(0, ids, data)
        return out[:num_segments]
    if data.dtype.is_floating_point:
        fill = -float("inf") if op == "amax" else float("inf")
    else:
        info = torch.iinfo(data.dtype)
        fill = info.min if op == "amax" else info.max
    out = torch.full(shape, fill, dtype=data.dtype, device=data.device)
    idx = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out.scatter_reduce_(0, idx, data, reduce=op, include_self=True)
    return out[:num_segments]


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (numeric) semiring with torch reduction plumbing."""

    name: str
    add: Callable[[Tensor, Tensor], Tensor]       # ⊕, elementwise
    mul: Callable[[Tensor, Tensor], Tensor]       # ⊗, elementwise
    zero: float                                    # identity of ⊕ (sparse "empty")
    one: float                                     # identity of ⊗
    reduce_op: str = "sum"                         # segment_reduce op for ⊕

    def reduce(self, data: Tensor, segment_ids: Tensor,
               num_segments: int) -> Tensor:
        return segment_reduce(data, segment_ids, num_segments, self.reduce_op)


PLUS_TIMES = Semiring("plus_times", torch.add, torch.mul, 0.0, 1.0, "sum")
MIN_PLUS = Semiring("min_plus", torch.minimum, torch.add, float(np.inf), 0.0,
                    "amin")
MAX_PLUS = Semiring("max_plus", torch.maximum, torch.add, float(-np.inf), 0.0,
                    "amax")
MAX_MIN = Semiring("max_min", torch.maximum, torch.minimum, 0.0,
                   float(np.inf), "amax")
MAX_TIMES = Semiring("max_times", torch.maximum, torch.mul, 0.0, 1.0, "amax")
OR_AND = Semiring(
    "or_and",
    lambda a, b: torch.logical_or(a != 0, b != 0).to(a.dtype),
    lambda a, b: torch.logical_and(a != 0, b != 0).to(a.dtype),
    0.0, 1.0, "amax",
)

REGISTRY: dict[str, Semiring] = {
    s.name: s
    for s in (PLUS_TIMES, MIN_PLUS, MAX_PLUS, MAX_MIN, MAX_TIMES, OR_AND)
}


def get(name_or_semiring: "str | Semiring") -> Semiring:
    if isinstance(name_or_semiring, Semiring):
        return name_or_semiring
    try:
        return REGISTRY[name_or_semiring]
    except KeyError:
        raise KeyError(
            f"unknown semiring {name_or_semiring!r}; "
            f"available: {sorted(REGISTRY)}") from None
