"""Host time a call of the planner's executor: the self time of the
program's ``planner.exec.*`` spans (one per DAG node the executor runs:
scans, selects, transposes, the string-key ``add``, the host SpGEMMs,
fused elementwise passes, sums; and ``planner.exec.align``, the key
alignment before a product) summed over the traced window's calls, over
the number of calls, in ms.  ``None`` when the program records no such
span.  Moves ``requests_per_s``."""

from bench.harness.spans import self_total

NAMES = ("planner.exec.*",)


def read(run):
    spans = run.layer.get("spans")
    if not spans or not any(s["name"].startswith("planner.exec.")
                            for sp in spans for s in sp):
        return None
    return 1e3 * sum(self_total(sp, NAMES) for sp in spans) / len(spans)
