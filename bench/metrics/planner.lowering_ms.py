"""Host time a call of the planner's device lowering: the self time of
the program's ``kernel.spmv``/``kernel.spmm`` spans (``_onto``, the ELL
pack, the copy to the card and the launch's enqueue) summed over the
traced window's calls, over the number of calls, in ms.  Moves
``requests_per_s``."""

from bench.harness.spans import self_total


def read(run):
    spans = run.layer.get("spans")
    if not spans:
        return None
    ms = sum(self_total(s, ("kernel.spmv", "kernel.spmm")) for s in spans)
    return 1e3 * ms / len(spans)
