"""Key handling for associative arrays.

D4M indexes arrays by arbitrary totally-ordered key sets — almost always
strings ("1.1.1.1", "ip.src|63.237.205.194", packet IDs).  This module
holds the host-side (numpy) machinery: parsing D4M's delimiter-terminated
key strings, canonical sorted-unique dictionaries, and the selector
objects used in subscripting (ranges, prefixes), and :func:`align`,
which lines two dictionaries up by integer index maps.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Optional, Sequence, Union

import numpy as np

from ..obs.metrics import REGISTRY as _REGISTRY

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
# Alignment of two sorted-unique dictionaries by integer index maps.
# ---------------------------------------------------------------------------

# Every alignment counts the path it took; /metrics shows the counts as
# repro_key_align_total{path=...}.
ALIGN_PATHS = ("same", "empty", "search", "merge")
_ALIGN_FAMILY = _REGISTRY.counter(
    "repro_key_align_total", "Key-dictionary alignments by path",
    labels=("path",))
_ALIGN_COUNTERS = {p: _ALIGN_FAMILY.labels(path=p) for p in ALIGN_PATHS}


def align_counts() -> dict:
    """Snapshot of the alignment counters by path (a copy, safe to diff)."""
    return {p: c.value for p, c in _ALIGN_COUNTERS.items()}


class Alignment(NamedTuple):
    """The aligned dictionary and, for each side, the position in it of
    every key of that side (-1 where it has no such key), or None where
    the side's keys are the aligned dictionary itself."""
    keys: np.ndarray
    ia: Optional[np.ndarray]
    ib: Optional[np.ndarray]
    path: str


def align(a: np.ndarray, b: np.ndarray, how: str) -> Alignment:
    """Intersect (``how="inter"``) or unite (``how="union"``) two sorted,
    unique key dictionaries without sorting their strings again.

    ``keys`` equals ``np.intersect1d(a, b)`` / ``np.union1d(a, b)`` in
    order and dtype.  The path follows from the inputs: ``same`` (``a is
    b`` or equal arrays: both maps the identity), ``empty`` (a side has
    no keys), ``search`` (the smaller side binary-searched into the
    larger, when its m·log2(n) comparisons cost less than a merge), else
    ``merge`` (a stable sort of the concatenation, which finds the two
    sorted runs and merges them in one pass).
    """
    if how not in ("inter", "union"):
        raise ValueError(f"how must be 'inter' or 'union', not {how!r}")
    dtype = np.promote_types(a.dtype, b.dtype)
    m, n = a.shape[0], b.shape[0]
    if a is b or (m == n and np.array_equal(a, b)):
        path, keys, ia, ib = "same", a, None, None
    elif m == 0 or n == 0:
        path = "empty"
        if how == "inter":
            keys = a[:0]
            ia, ib = np.full(m, -1, np.int64), np.full(n, -1, np.int64)
        else:
            keys = b if m == 0 else a   # its map becomes None below
            ia, ib = np.empty(m, np.int64), np.empty(n, np.int64)
    elif min(m, n) * max(m, n).bit_length() < m + n:
        path = "search"
        if m <= n:
            keys, ia, ib = _search(a, b, how, dtype)
        else:
            keys, ib, ia = _search(b, a, how, dtype)
    else:
        path = "merge"
        keys, ia, ib = _merge(a, b, how)
    _ALIGN_COUNTERS[path].inc()
    k = keys.shape[0]
    return Alignment(keys.astype(dtype, copy=False),
                     None if m == k else ia, None if n == k else ib, path)


def _search(s: np.ndarray, big: np.ndarray, how: str, dtype):
    """:func:`align` with the small side ``s`` searched into ``big``."""
    m, n = s.shape[0], big.shape[0]
    lo = np.searchsorted(big, s)
    hit = big[np.minimum(lo, n - 1)] == s
    k = int(np.count_nonzero(hit))
    if how == "inter":
        ms = np.where(hit, np.cumsum(hit) - 1, -1)
        mb = np.full(n, -1, np.int64)
        mb[lo[hit]] = np.arange(k)
        return s[hit], ms, mb
    # keys of big below s[i], less those s[:i] shares with big
    ms = np.arange(m) + lo - (np.cumsum(hit) - hit)
    free = np.ones(m + n - k, bool)
    free[ms] = False
    shared = np.zeros(n, bool)
    shared[lo[hit]] = True
    mb = np.empty(n, np.int64)
    mb[shared] = ms[hit]
    mb[~shared] = np.flatnonzero(free)  # big's own keys fill the gaps
    keys = np.empty(m + n - k, dtype)
    keys[ms] = s
    keys[mb] = big
    return keys, ms, mb


def _merge(a: np.ndarray, b: np.ndarray, how: str):
    """:func:`align` by one stable merge of the two sorted runs."""
    m = a.shape[0]
    cat = np.concatenate([a, b])
    order = np.argsort(cat, kind="stable")
    srt = cat[order]
    dup = srt[1:] == srt[:-1]       # (a's key, b's equal key), in order
    if how == "inter":
        pa, pb = order[:-1][dup], order[1:][dup] - m
        ia = np.full(m, -1, np.int64)
        ib = np.full(b.shape[0], -1, np.int64)
        ia[pa] = ib[pb] = np.arange(pa.shape[0])
        return srt[1:][dup], ia, ib
    first = np.ones(cat.shape[0], bool)
    first[1:] = ~dup
    pos = np.empty(cat.shape[0], np.int64)
    pos[order] = np.cumsum(first) - 1
    return srt[first], pos[:m], pos[m:]


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
    # invariant every other Assoc path (and keys.align) relies on
    return np.unique(idx[hit]).astype(np.int64)
