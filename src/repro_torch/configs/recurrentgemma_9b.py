"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; unverified]  38L d_model=4096 16H (GQA kv=1, i.e. MQA)
d_ff=12288 vocab=256000; block period (R, R, L) with window 2048.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000,
    pattern="RRL", window=2048,
    rope_theta=10_000.0, logit_softcap=30.0,
    tie_embeddings=True,          # Gemma family ties embeddings
)
