#!/usr/bin/env python3
"""Count the global atomics that ``segsum``'s slot-table policies leave on
chip_smoke's kernel window, on the host (no card needed):

    python3 scripts/segsum_claims.py

Takes a 4 s window of the kernel window's traffic (the same generator,
about 0.4 M packets x 9 fields, row-major), cuts it into the element
chunks one block sees, and replays a table of 2^bits slots in each: an id
hashes to one slot, claims it when the slot is empty (on its first
sighting, or on its second with a direct-mapped table of 4,096 last-seen
ids), and every element of an unclaimed id is one global atomic; each
claimed slot is one more at the end.  Prints the atomics an element for
each policy beside the distinct ids an element, the least any per-block
policy could reach only if every block saw every id.  The order within a
chunk is the array's, not the kernel's interleaving, so the counts show
the policies' differences, not the kernel's exact count.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (elements a block sees, slot bits): the first design's 1,056 blocks of a
# 54 M-id window and 2,048 slots; the shipped one block an SM, 16,384.
POLICIES = [(51_200, 11), (409_600, 14)]


def slots(x: np.ndarray, bits: int) -> list:
    return (((x.astype(np.uint64) * 2654435761) & 0xffffffff)
            >> (32 - bits)).tolist()


def atomics(ids: np.ndarray, chunk: int, bits: int, second: bool) -> int:
    total = 0
    for c0 in range(0, ids.size, chunk):
        c = ids[c0:c0 + chunk]
        c = c[c >= 0]
        table: dict = {}
        seen: dict = {}
        for x, s, q in zip(c.tolist(), slots(c, bits), slots(c, 12)):
            owner = table.get(s)
            if owner == x:
                continue
            if owner is None:
                if not second or seen.get(q) == x:
                    table[s] = x
                    continue
                seen[q] = x
            total += 1
        total += len(table)
    return total


def main() -> int:
    ecols, _, n_cols = cs.window_ell(duration_s=4.0)
    ids = ecols.reshape(-1)
    n = ids.size
    distinct = np.unique(ids[ids >= 0]).size
    print(f"[claims] 4 s window: {n} ids, {n_cols} columns, "
          f"{distinct / n:.3f} distinct ids an element")
    for chunk, bits in POLICIES:
        for second in (False, True):
            rule = "second" if second else "first"
            print(f"[claims] {chunk} elements a block, {1 << bits} slots, "
                  f"claim on {rule} sighting: "
                  f"{atomics(ids, chunk, bits, second) / n:.3f} global "
                  f"atomics an element")
    return 0


if __name__ == "__main__":
    sys.exit(main())
