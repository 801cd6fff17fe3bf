"""granite-moe-3b-a800m — fine-grained MoE, top-8 routing.

[hf:ibm-granite/granite-3.0-1b-a400m-base (family); hf]
32L d_model=1536 24H (GQA kv=8) vocab=49155; MoE 40 experts top-8 with
d_expert=512 (the assignment lists both "40e" and "32 experts"; we take
the explicit 40e field and note the discrepancy in DESIGN.md).
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    pattern="A", tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
    # H=24 doesn't divide tp=16 → pad to 32 physical heads (masked;
    # math exactly the 24-head model — see launch/calibrate.py)
    head_pad=32,
)
