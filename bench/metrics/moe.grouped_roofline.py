"""The expert layers' grouped products' share of their roofline over
the serving cell's traced window: for every prefill and decode step (a
``model.prefill`` or ``model.decode_step`` span), the least time of the
three products of each of its ``moe.experts`` calls (from the rows
routed and the experts that got rows, the span's tags, and the
configuration's widths: ``bench/yardstick/experts.py``) over the
profiler's device time of the grouped-product launches that ran inside
the span.  A step counts only where the program tagged its calls and
the profiler recorded the launches.  Moves ``requests_per_s``."""

from bisect import bisect_left, bisect_right

from bench.yardstick.experts import expert_seconds
from bench.yardstick.model_flops import dims

# the device kernels of torch._grouped_mm (bfloat16, sm_90)
KERNELS = ("GroupProblemShape",)
STEPS = ("model.prefill", "model.decode_step")


def read(run):
    p, spans = run.profile, run.layer.get("spans")
    if p is None or not spans:
        return None
    m = dims(run.layer["cfg"])
    gemm = sorted((p.wall(s), p.wall(e)) for name, s, e in p.events
                  if any(k in name for k in KERNELS))
    starts = [s for s, _ in gemm]
    need = spent = 0.0
    for sp in spans:
        kids = {}
        for c in sp:
            if c["name"] == "moe.experts" and \
                    c["tags"].get("experts_hit") is not None:
                kids.setdefault(c["parent_id"], []).append(c["tags"])
        for s in sp:
            if s["name"] not in STEPS:
                continue
            calls = kids.get(s["span_id"], [])
            w0, w1 = s["start"], s["start"] + s["dur_s"]
            got = [e - st for st, e in gemm[bisect_left(starts, w0):
                                            bisect_right(starts, w1)]]
            if not calls or not got:
                continue
            need += sum(expert_seconds(t["rows"], t["experts_hit"], m["d"],
                                       m["f"]) for t in calls)
            spent += sum(got)
    return 100.0 * need / spent if spent > 0 else None
