"""The operations one request of a decoder with GQA attention (full and
sliding-window layers) and a sparse MLP on every layer needs, counted
from the published configuration's keys, the same whatever implements
it: the model FLOPs of an MFU.

A request is a prompt of ``prompt`` tokens, then ``new`` decode steps
at positions prompt .. prompt + new - 1.  A token costs, a layer: its
q, k, v and o projections, the router, ``num_experts_per_tok`` SwiGLU
experts, and attention over the keys its layer's mask lets through
(``attention.visible_pairs``).  Logits are counted where a step needs
them: the prompt's last position and each decode step.  2 operations a
multiply-add.  Later PRs of the program do not edit this file.
"""
from __future__ import annotations

from .attention import visible_pairs


def dims(cfg: dict) -> dict:
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return {"d": d, "h": h, "kv": int(cfg["num_key_value_heads"]),
            "dh": int(cfg.get("head_dim") or d // h),
            "e": int(cfg["num_experts"]), "k": int(cfg["num_experts_per_tok"]),
            "f": int(cfg["moe_intermediate_size"]),
            "v": int(cfg["vocab_size"]), "window": int(cfg["sliding_window"])}


def request_flops(cfg: dict, prompt: int, new: int) -> int:
    m = dims(cfg)
    d, dh = m["d"], m["dh"]
    per_token = (2 * d * dh * (2 * m["h"] + 2 * m["kv"])     # q, k, v, o
                 + 2 * d * m["e"]                             # router
                 + m["k"] * 3 * 2 * d * m["f"])               # experts
    tokens = prompt + new
    total = 0
    for kind in cfg["layer_types"]:
        window = m["window"] if kind == "sliding_attention" else 0
        pairs = visible_pairs(prompt, prompt, window) + sum(
            visible_pairs(1, prompt + s + 1, window) for s in range(new))
        total += tokens * per_token + 4 * dh * m["h"] * pairs
    return total + (1 + new) * 2 * d * m["v"]
