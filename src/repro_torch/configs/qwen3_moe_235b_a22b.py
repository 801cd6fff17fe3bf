"""qwen3-moe-235b-a22b — 128-expert MoE, top-8, GQA kv=4, head_dim 128.

[hf:Qwen/Qwen3-30B-A3B (family); hf]  94L d_model=4096 64H (GQA kv=4)
vocab=151936; MoE 128 experts top-8, d_expert=1536.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    pattern="A", rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
)
