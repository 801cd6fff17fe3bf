"""The flash attention kernel's share of its roofline at latent
attention's shapes over the serving cell's traced window: for every
batch's prefill (a ``model.prefill`` span), the least time of its
``attn.mla`` calls of form ``decompressed`` (the unmasked pairs' work
at q/k and v head widths, and Q, K, V, O once, from
``bench/yardstick/mla_attention.py``, at each call's tags ``batch``,
``tokens`` and ``keys``) over the profiler's device time of the flash
launches that ran inside the span.  A prefill counts only where the
program tagged its calls and the profiler recorded its launches.
Moves ``requests_per_s``."""

from bisect import bisect_left, bisect_right

from bench.yardstick.mla_attention import mla_seconds

KERNELS = ("flash_tc_kernel", "flash_kernel")


def read(run):
    p, spans = run.profile, run.layer.get("spans")
    if p is None or not spans:
        return None
    cfg = run.layer["cfg"]
    h = int(cfg["num_attention_heads"])
    dqk = int(cfg["qk_nope_head_dim"]) + int(cfg["qk_rope_head_dim"])
    dv = int(cfg["v_head_dim"])
    flash = sorted((p.wall(s), p.wall(e)) for name, s, e in p.events
                   if any(k in name for k in KERNELS))
    starts = [s for s, _ in flash]
    need = spent = 0.0
    for sp in spans:
        kids = {}
        for c in sp:
            if c["name"] == "attn.mla" and \
                    c["tags"].get("form") == "decompressed":
                kids.setdefault(c["parent_id"], []).append(c["tags"])
        for s in sp:
            if s["name"] != "model.prefill":
                continue
            calls = kids.get(s["span_id"], [])
            w0, w1 = s["start"], s["start"] + s["dur_s"]
            got = [e - st for st, e in flash[bisect_left(starts, w0):
                                             bisect_right(starts, w1)]]
            if not calls or not got:
                continue
            need += sum(mla_seconds(t["batch"], t["tokens"] // t["batch"],
                                    t["keys"], h, dqk, dv) for t in calls)
            spent += sum(got)
    return 100.0 * need / spent if spent > 0 else None
