"""Key handling for associative arrays.

D4M indexes arrays by arbitrary totally-ordered key sets — almost always
strings ("1.1.1.1", "ip.src|63.237.205.194", packet IDs).  This module
holds the host-side (numpy) machinery: parsing D4M's delimiter-terminated
key strings, canonical sorted-unique dictionaries, and the selector
objects used in subscripting (ranges, prefixes).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Union

import numpy as np

# D4M convention: a single string whose *last* character is the delimiter
# encodes a key list, e.g. 'a,b,c,' or 'ip.src|1.2.3.4|'.
KeysLike = Union[str, bytes, int, float, Sequence, np.ndarray]


def parse_keys(keys: KeysLike) -> np.ndarray:
    """Normalize any key spec to a 1-D numpy unicode array (not uniqued)."""
    if isinstance(keys, np.ndarray):
        if keys.dtype.kind in "US":
            return keys.astype(str)
        return keys.astype(str)
    if isinstance(keys, bytes):
        keys = keys.decode()
    if isinstance(keys, str):
        if len(keys) == 0:
            return np.empty((0,), dtype="U1")
        sep = keys[-1]
        parts = keys.split(sep)[:-1]  # trailing sep → drop final empty
        return np.asarray(parts, dtype=str)
    if isinstance(keys, (int, float, np.integer, np.floating)):
        return np.asarray([keys], dtype=str) if isinstance(keys, float) \
            else np.asarray([str(keys)])
    if isinstance(keys, Iterable):
        return np.asarray([k.decode() if isinstance(k, bytes) else str(k)
                           for k in keys], dtype=str)
    raise TypeError(f"cannot interpret keys from {type(keys)!r}")


def unique_keys(keys: KeysLike) -> tuple[np.ndarray, np.ndarray]:
    """Return (sorted-unique dictionary, index of each input key)."""
    arr = parse_keys(keys)
    uniq, inv = np.unique(arr, return_inverse=True)
    return uniq, inv.astype(np.int64)


# ---------------------------------------------------------------------------
# Selectors — the things that can appear in A[rsel, csel].
# ---------------------------------------------------------------------------

class Selector:
    def mask(self, dictionary: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class All(Selector):
    """The ':' selector."""

    def mask(self, dictionary: np.ndarray) -> np.ndarray:
        return np.ones(dictionary.shape[0], dtype=bool)


@dataclasses.dataclass(frozen=True)
class KeyRange(Selector):
    """Inclusive lexicographic range — D4M's 'a,:,b,'."""
    start: str
    stop: str

    def mask(self, dictionary: np.ndarray) -> np.ndarray:
        return (dictionary >= self.start) & (dictionary <= self.stop)


@dataclasses.dataclass(frozen=True)
class StartsWith(Selector):
    """Prefix scan — D4M's StartsWith('ip.src|,'); how one selects all
    columns of a given field in the exploded schema."""
    prefix: str

    def mask(self, dictionary: np.ndarray) -> np.ndarray:
        n = len(self.prefix)
        if n == 0:
            return np.ones(dictionary.shape[0], dtype=bool)
        # Vectorized prefix test on the sorted dictionary via range trick:
        # keys with this prefix form a contiguous lexicographic band.
        lo = np.searchsorted(dictionary, self.prefix, side="left")
        hi = np.searchsorted(dictionary, self.prefix + "￿", side="right")
        m = np.zeros(dictionary.shape[0], dtype=bool)
        m[lo:hi] = True
        return m


def resolve_selector(sel, dictionary: np.ndarray) -> np.ndarray:
    """Map a user selector to integer indices into ``dictionary``.

    Accepts: ':' / slice(None) / Selector / key list (string forms per
    parse_keys) / boolean mask / integer array.
    """
    if isinstance(sel, str) and sel == ":":
        sel = All()
    if sel is None or (isinstance(sel, slice) and sel == slice(None)):
        sel = All()
    if isinstance(sel, Selector):
        return np.nonzero(sel.mask(dictionary))[0]
    if isinstance(sel, np.ndarray) and sel.dtype == bool:
        return np.nonzero(sel)[0]
    if isinstance(sel, np.ndarray) and sel.dtype.kind in "iu":
        return sel.astype(np.int64)
    # D4M range string: 'a,:,b,'
    if isinstance(sel, str):
        parts = parse_keys(sel)
        if parts.shape[0] == 3 and parts[1] == ":":
            return np.nonzero(KeyRange(str(parts[0]), str(parts[2]))
                              .mask(dictionary))[0]
    wanted = parse_keys(sel)
    if dictionary.shape[0] == 0 or wanted.shape[0] == 0:
        return np.empty((0,), np.int64)
    # D4M prefix atoms: a key ending in '*' selects every key with that
    # prefix ('ip.src|*,' → the whole ip.src column block).
    stars = np.char.endswith(wanted, "*")
    if stars.any():
        m = np.zeros(dictionary.shape[0], dtype=bool)
        for k, is_prefix in zip(wanted, stars):
            if is_prefix:
                m |= StartsWith(str(k[:-1])).mask(dictionary)
            else:
                m |= dictionary == k
        return np.nonzero(m)[0]
    idx = np.searchsorted(dictionary, wanted)
    idx = np.clip(idx, 0, max(dictionary.shape[0] - 1, 0))
    hit = dictionary[idx] == wanted
    # sorted-unique: result arrays must keep the sorted-dictionary
    # invariant every other Assoc path (and _onto alignment) relies on
    return np.unique(idx[hit]).astype(np.int64)
