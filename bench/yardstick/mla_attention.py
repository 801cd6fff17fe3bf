"""The work one causal latent-attention call needs in its decompressed
form (DeepSeek-V2's prefill), and its least time on the card, counted
from the shapes the configuration asks for, the same whatever
implements it (a kernel that pads v to the q/k head width computes
more, and is not credited for it).

Only the causal (row, key) pairs count (``attention.visible_pairs``).
Each pair costs 2·(dqk + dv) operations a head (q·k over the q/k head
width, p·v over the v head width).  Q and K are read once at dqk, V
read and O written once at dv, a head each, 2 bytes an element
(bfloat16).  Later PRs of the program do not edit this file.
"""
from __future__ import annotations

from .attention import visible_pairs
from .peaks import BF16_FLOPS, HBM_BYTES_PER_S

BYTES = 2           # bfloat16


def mla_flops(b: int, sq: int, sk: int, heads: int, dqk: int,
              dv: int) -> int:
    return 2 * (dqk + dv) * b * heads * visible_pairs(sq, sk)


def mla_bytes(b: int, sq: int, sk: int, heads: int, dqk: int,
              dv: int) -> int:
    """Q and O of the queries, K and V of the keys, once each."""
    return BYTES * b * heads * (sq * (dqk + dv) + sk * (dqk + dv))


def mla_seconds(b: int, sq: int, sk: int, heads: int, dqk: int,
                dv: int) -> float:
    """The larger of the bytes at the HBM rate and the operations at the
    bfloat16 tensor-core rate."""
    return max(mla_bytes(b, sq, sk, heads, dqk, dv) / HBM_BYTES_PER_S,
               mla_flops(b, sq, sk, heads, dqk, dv) / BF16_FLOPS)
