"""mellum2-12b-a2.5b — 64-expert top-8 MoE on every layer; three
sliding-window layers to one full layer, YaRN on the full layers.

[hf:JetBrains/Mellum2-12B-A2.5B-Instruct config.json]  28L (7 periods of
sliding, sliding, sliding, full) d_model=2304 32H (GQA kv=4) head_dim=128
vocab=98304 (untied); sliding window 1024; rope_parameters:
full_attention YaRN (theta 500000, factor 16, original context 8192,
beta_fast 32, beta_slow 1, attention_factor 1.2772588722239782),
sliding_attention the default rope at theta 500000; every MLP sparse:
64 experts, top-8, norm_topk_prob, expert width 896, no shared expert;
RMSNorm eps 1e-6.  ``d_ff`` holds the config's dense width (7168),
which no layer uses.  Not built: the MTP head the model card mentions
(the config has no key for it; next-token serving does not run it).
Assumed: a softmax router (the config names no scoring function) and no
q/k norm.  12,149,915,904 parameters: served in bfloat16 on one card.
"""
from ..models.config import ModelConfig, MoEConfig, RopeConfig

CONFIG = ModelConfig(
    name="mellum2-12b-a2.5b",
    n_layers=28, d_model=2304, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=7168, vocab=98304,
    pattern="LLLA", window=1024,
    rope_theta=500_000.0,
    rope_global=RopeConfig(theta=500_000.0, kind="yarn", factor=16.0,
                           original_max_position=8192, beta_fast=32.0,
                           beta_slow=1.0,
                           attention_factor=1.2772588722239782),
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=896, dropless=True),
    attention_impl="pallas",
    serve_param_dtype="bfloat16",
)
