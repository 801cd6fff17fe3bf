"""The operations one request of a DeepSeek-V2 decoder (latent
attention, leading dense layers, routed and shared experts) needs,
counted from the published configuration's keys, the same whatever
implements it: the model FLOPs of an MFU.

A request is a prompt of ``prompt`` tokens, then ``new`` decode steps
at positions prompt .. prompt + new - 1.  A token costs, a layer: its
q (D to H·(dn + dr)), kv_a (D to R + dr), kv_b (R to H·(dn + dv)) and o
(H·dv to D) projections; on the first ``first_k_dense_replace`` layers
a SwiGLU of width ``intermediate_size``, on the others the router,
``num_experts_per_tok`` SwiGLU experts of width
``moe_intermediate_size`` and the shared SwiGLU of width
``n_shared_experts · moe_intermediate_size``; and attention over the
causal keys (``attention.visible_pairs``) at 2·H·(dn + dr + dv) a pair,
the decompressed form's work whatever form computes it.  Logits are
counted where a step needs them: the prompt's last position and each
decode step.  2 operations a multiply-add.  Later PRs of the program do
not edit this file.
"""
from __future__ import annotations

from .attention import visible_pairs


def request_flops(cfg: dict, prompt: int, new: int) -> int:
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    r, dn = int(cfg["kv_lora_rank"]), int(cfg["qk_nope_head_dim"])
    dr, dv = int(cfg["qk_rope_head_dim"]), int(cfg["v_head_dim"])
    e, k = int(cfg["n_routed_experts"]), int(cfg["num_experts_per_tok"])
    f, fd = int(cfg["moe_intermediate_size"]), int(cfg["intermediate_size"])
    fs = f * int(cfg.get("n_shared_experts") or 0)
    attn = 2 * (d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
                + h * dv * d)
    dense = 3 * 2 * d * fd
    sparse = 2 * d * e + k * 3 * 2 * d * f + 3 * 2 * d * fs
    pairs = visible_pairs(prompt, prompt) + sum(
        visible_pairs(1, prompt + s + 1) for s in range(new))
    tokens = prompt + new
    total = 0
    for i in range(int(cfg["num_hidden_layers"])):
        mlp = dense if i < int(cfg["first_k_dense_replace"]) else sparse
        total += tokens * (attn + mlp) + 2 * h * (dn + dr + dv) * pairs
    return total + (1 + new) * 2 * d * int(cfg["vocab_size"])
