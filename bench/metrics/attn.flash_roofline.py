"""The flash attention kernel's share of its roofline over the serving
cell's traced window: for every batch's prefill (a ``model.prefill``
span), the least time of its attention layers (the unmasked pairs' work
and Q, K, V, O once, from ``bench/yardstick/attention.py``, at the
batch's shapes and each layer's window) over the profiler's device time
of the flash launches that ran inside the span.  A prefill counts only
where the profiler recorded its launches.  Moves ``requests_per_s``."""

from bisect import bisect_left, bisect_right

from bench.yardstick.attention import flash_seconds
from bench.yardstick.model_flops import dims

KERNELS = ("flash_tc_kernel", "flash_kernel")


def read(run):
    p, spans = run.profile, run.layer.get("spans")
    if p is None or not spans:
        return None
    cfg = run.layer["cfg"]
    m = dims(cfg)
    flash = sorted((p.wall(s), p.wall(e)) for name, s, e in p.events
                   if any(k in name for k in KERNELS))
    starts = [s for s, _ in flash]
    need = spent = 0.0
    for sp in spans:
        for s in sp:
            if s["name"] != "model.prefill":
                continue
            w0, w1 = s["start"], s["start"] + s["dur_s"]
            got = [e - st for st, e in flash[bisect_left(starts, w0):
                                             bisect_right(starts, w1)]]
            if not got:
                continue
            b = s["tags"]["batch"]
            n = s["tags"]["tokens"] // b
            need += sum(flash_seconds(
                b, n, n, m["h"], m["kv"], m["dh"],
                m["window"] if kind == "sliding_attention" else 0)
                for kind in cfg["layer_types"])
            spent += sum(got)
    return 100.0 * need / spent if spent > 0 else None
