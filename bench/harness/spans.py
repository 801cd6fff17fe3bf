"""Arithmetic over the program's span records (``repro_torch.obs.trace``
flat records: ``span_id``, ``parent_id``, ``name``, ``start`` on the wall
clock, ``dur_s``)."""
from __future__ import annotations


def self_seconds(spans: list) -> dict:
    """span_id -> the span's duration less the part of it that its
    children cover."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s)
    out = {}
    for s in spans:
        t0, t1 = s["start"], s["start"] + s["dur_s"]
        cover, end = 0.0, t0
        for c in sorted(kids.get(s["span_id"], []), key=lambda c: c["start"]):
            c0, c1 = max(c["start"], end), min(c["start"] + c["dur_s"], t1)
            if c1 > c0:
                cover += c1 - c0
                end = c1
        out[s["span_id"]] = max(s["dur_s"] - cover, 0.0)
    return out


def self_total(spans: list, names) -> float:
    """Summed self time of the spans named in ``names`` (a name ending in
    ``*`` matches by prefix)."""
    own = self_seconds(spans)
    return sum(own[s["span_id"]] for s in spans if _match(s["name"], names))


def total(spans: list, names) -> float:
    """Summed duration of the spans named in ``names``."""
    return sum(s["dur_s"] for s in spans if _match(s["name"], names))


def host_intervals(spans: list) -> list:
    """(start, end, name, depth) of every span, depth 0 at the root."""
    by_id = {s["span_id"]: s for s in spans}
    out = []
    for s in spans:
        depth, p = 0, s["parent_id"]
        while p in by_id:
            depth += 1
            p = by_id[p]["parent_id"]
        out.append((s["start"], s["start"] + s["dur_s"], s["name"], depth))
    return out


def _match(name: str, names) -> bool:
    return any(name.startswith(n[:-1]) if n.endswith("*") else name == n
               for n in names)
