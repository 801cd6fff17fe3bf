"""Model FLOP utilization of a latent-attention cell's traced window:
the operations the window's requests need, counted from the
configuration's shapes (``bench/yardstick/mla_flops.py``: projections,
the dense or the routed and shared experts, causal attention in the
decompressed form, logits), over the window's time at the card's
bfloat16 peak (989 TFLOP/s, ``bench/yardstick/peaks.py``), in %.  A
batch that failed counts nothing.  ``None`` off a card.  Moves
``requests_per_s``."""

from bench.yardstick.mla_flops import request_flops
from bench.yardstick.peaks import BF16_FLOPS


def read(run):
    lay = run.layer
    if not lay.get("on_card") or not lay.get("done") or not lay["window_s"]:
        return None
    cfg, new, b = lay["cfg"], lay["new_tokens"], lay["batch"]
    per = {}
    flops = 0
    for n, *_, served in lay["done"]:
        if served:
            if n not in per:
                per[n] = request_flops(cfg, n, new)
            flops += b * per[n]
    return 100.0 * flops / (lay["window_s"] * BF16_FLOPS)
