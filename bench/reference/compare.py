"""The comparisons that decide ``correct``: each turns a program answer
and the reference's into one number, to be held under a limit.

Program answers are first brought to plain arrays (``assoc_column``);
everything after that is NumPy and imports nothing of the program.
"""
from __future__ import annotations

import numpy as np


def assoc_column(col, name: str):
    """A one-column answer (rows = packet ids ``%09d``) as (packet
    indices, values); a column under another name reads as missing."""
    r, c, v = col.triples()
    if r.shape[0] and not (np.asarray(c) == name).all():
        return np.zeros(0, np.int64), np.zeros(0)
    return np.asarray(r).astype(np.int64), np.asarray(v, np.float64)


def column_gap(got, want) -> float:
    """Largest |got - want| over the union of rows, a missing row
    counting as 0 (exact integers: any gap is a wrong answer)."""
    gi, gv = got
    wi, wv = want
    idx = np.union1d(gi, wi)
    a = np.zeros(idx.shape[0])
    b = np.zeros(idx.shape[0])
    a[np.searchsorted(idx, gi)] = gv
    b[np.searchsorted(idx, wi)] = wv
    return float(np.abs(a - b).max()) if idx.shape[0] else 0.0


def fit_rel(got: dict, want: dict) -> float:
    """Largest relative error of alpha, log_c and r2."""
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
               for k in ("alpha", "log_c", "r2"))


def ranking(got_keys, got_scores, want_keys, want_scores, k: int) -> float:
    """How far a top-k answer is from the reference's, over the top
    reference score: the larger of (a) the largest shortfall, over
    positions i, of the reference score of the answer's i-th key below
    the reference's own i-th score (0 when the answer ranks as the
    reference does; exact ties may swap) and (b) the largest |answer
    score - reference score| of the answer's keys.  1 for a key the
    reference does not have, or an answer of the wrong length."""
    order = np.argsort(-np.asarray(want_scores), kind="stable")
    top = float(want_scores[order[0]]) if order.shape[0] else 1.0
    top = max(abs(top), 1e-30)
    by_key = dict(zip(np.asarray(want_keys).tolist(),
                      np.asarray(want_scores, np.float64).tolist()))
    got_keys = np.asarray(got_keys).tolist()
    if len(got_keys) != min(k, order.shape[0]):
        return 1.0
    gap = 0.0
    for i, key in enumerate(got_keys):
        if key not in by_key:
            return 1.0
        gap = max(gap, (float(want_scores[order[i]]) - by_key[key]) / top,
                  abs(float(got_scores[i]) - by_key[key]) / top)
    return gap


def vector_rel(got, want) -> float:
    """Largest |got - want| over max |want| of a keyed vector; 1 when the
    keys differ."""
    gk, gv = got
    wk, wv = want
    if gk.shape != wk.shape or not (np.asarray(gk) == np.asarray(wk)).all():
        return 1.0
    scale = max(float(np.abs(wv).max()), 1e-30) if wv.shape[0] else 1.0
    return float(np.abs(np.asarray(gv) - wv).max()) / scale \
        if wv.shape[0] else 0.0


def keyed_gap(got_keys, got_vals, want: dict) -> float:
    """Largest |got - want[key]| over an answer's keys (a key the
    reference lacks counts as its whole value)."""
    gap = 0.0
    for k, v in zip(got_keys, got_vals):
        gap = max(gap, abs(float(v) - want.get(k, 0.0)))
    return gap
