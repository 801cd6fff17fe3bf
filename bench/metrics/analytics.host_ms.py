"""Host time a call of the analytics outside the planner: the self time
of the program's ``analytics.*`` spans (``fit_degree_table``,
``c2_scores`` and its blocks, ``pagerank_table`` and its phases: key
stripping, ``Assoc`` builds, ``graph.square``, ``device_coo``, the
PageRank enqueue, c2's ``bincount`` statistics) summed over the traced
window's calls, over the number of calls, in ms.  ``None`` when the
program records no such span.  Moves ``requests_per_s``."""

from bench.harness.spans import self_total

NAMES = ("analytics.*",)


def read(run):
    spans = run.layer.get("spans")
    if not spans or not any(s["name"].startswith("analytics.")
                            for sp in spans for s in sp):
        return None
    return 1e3 * sum(self_total(sp, NAMES) for sp in spans) / len(spans)
