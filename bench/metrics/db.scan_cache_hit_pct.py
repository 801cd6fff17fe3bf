"""Share of the traced window's scans that the binding's ScanCache
served: 100 x hits / (hits + misses), over the ``cache`` tag of each
``db.scan`` span ("hit" or "miss") and the ``hits``/``misses`` tags of
each ``db.scan_batch`` span (the batch's members the cache saw).
``None`` when no scan went through a cache.  Moves ``requests_per_s``."""


def read(run):
    hits = misses = 0
    for spans in run.layer.get("spans") or ():
        for s in spans:
            tags = s.get("tags", {})
            if s["name"] == "db.scan" and "cache" in tags:
                hits += tags["cache"] == "hit"
                misses += tags["cache"] == "miss"
            elif s["name"] == "db.scan_batch":
                hits += int(tags.get("hits", 0))
                misses += int(tags.get("misses", 0))
    return 100.0 * hits / (hits + misses) if hits + misses else None
