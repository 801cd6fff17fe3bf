"""The work one causal attention call needs, and its least time on the
card, counted from the shapes the configuration asks for, the same
whatever implements it.

Only the (row, key) pairs the masks let through count: causal, and
within ``window`` positions where it is not 0.  Each pair costs 4·Dh
operations a head (q·k and p·v).  Q, K, V are read once and O written
once, 2 bytes an element (bfloat16).  The pair count follows
``visible_pairs`` in ``chip_smoke.py`` at commit
85961ce6c12ae82351317bcfa551ddc6181a2587; the bytes its ``flash_bound``.
Later PRs of the program do not edit this file.
"""
from __future__ import annotations

from .peaks import BF16_FLOPS, HBM_BYTES_PER_S

BYTES = 2           # bfloat16


def visible_pairs(sq: int, sk: int, window: int = 0) -> int:
    """Causal (row, key) pairs of queries at positions sk-sq .. sk-1 over
    keys 0 .. sk-1 (a prompt when sq == sk, one decode step when sq ==
    1), within ``window`` when it is not 0: row i sees min(i + 1,
    window) keys."""
    lo = sk - sq

    def tri(n):             # rows 0 .. n-1 with no window: 1 + ... + n
        return n * (n + 1) // 2
    if not window or window >= sk:
        return tri(sk) - tri(lo)
    cut = max(lo, window - 1)           # from row cut on, window keys
    return tri(cut) - tri(lo) + (sk - cut) * window


def flash_flops(b: int, sq: int, sk: int, heads: int, head_dim: int,
                window: int = 0) -> int:
    return 4 * head_dim * b * heads * visible_pairs(sq, sk, window)


def flash_bytes(b: int, sq: int, sk: int, heads: int, kv_heads: int,
                head_dim: int) -> int:
    """Q and O of the queries, K and V of the keys, once each."""
    return BYTES * b * head_dim * (2 * sq * heads + 2 * sk * kv_heads)


def flash_seconds(b: int, sq: int, sk: int, heads: int, kv_heads: int,
                  head_dim: int, window: int = 0) -> float:
    """The larger of the bytes at the HBM rate and the operations at the
    bfloat16 tensor-core rate."""
    return max(flash_bytes(b, sq, sk, heads, kv_heads, head_dim)
               / HBM_BYTES_PER_S,
               flash_flops(b, sq, sk, heads, head_dim, window) / BF16_FLOPS)
