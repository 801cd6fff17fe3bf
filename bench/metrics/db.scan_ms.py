"""Host time a call of the binding's scans: the self time of the
program's ``db.scan``/``db.scan_batch`` spans (route, ScanCache and the
edge store) summed over the traced window's calls, over the number of
calls, in ms.  Moves ``requests_per_s``."""

from bench.harness.spans import self_total


def read(run):
    spans = run.layer.get("spans")
    if not spans:
        return None
    s = sum(self_total(sp, ("db.scan", "db.scan_batch")) for sp in spans)
    return 1e3 * s / len(spans)
