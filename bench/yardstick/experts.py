"""The work one call of a SwiGLU expert layer needs, and the least time
of its three grouped products on the card, counted from the rows routed
and the configuration's widths, the same whatever implements it.

``rows`` (token, expert) pairs run through experts of width ``d``
(hidden) and ``f`` (expert): the gate and up products (rows × d by d ×
f) and the down product (rows × f by f × d), 2·rows·d·f operations
each.  Bytes, 2 an element (bfloat16), each product's inputs read once
and its output written once: the weights of the ``experts_hit`` experts
that got rows (d·f a product), the rows' activations in and out.
Later PRs of the program do not edit this file.
"""
from __future__ import annotations

from .peaks import BF16_FLOPS, HBM_BYTES_PER_S

BYTES = 2           # bfloat16


def expert_flops(rows: int, d: int, f: int) -> int:
    return 3 * 2 * rows * d * f


def expert_bytes(rows: int, experts_hit: int, d: int, f: int) -> int:
    weights = 3 * experts_hit * d * f
    # gate and up: rows·d in, rows·f out; down: rows·f in, rows·d out
    acts = 2 * (rows * d + rows * f) + (rows * f + rows * d)
    return BYTES * (weights + acts)


def expert_seconds(rows: int, experts_hit: int, d: int, f: int) -> float:
    """The larger of the bytes at the HBM rate and the operations at the
    bfloat16 tensor-core rate."""
    return max(expert_bytes(rows, experts_hit, d, f) / HBM_BYTES_PER_S,
               expert_flops(rows, d, f) / BF16_FLOPS)
