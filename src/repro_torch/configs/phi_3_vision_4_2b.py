"""phi-3-vision-4.2b — phi3-mini backbone + CLIP patch-embedding stub.

[hf:microsoft/Phi-3-vision-128k-instruct; hf]  32L d_model=3072 32H
(kv=32) d_ff=8192 vocab=32064; 576 image-prefix tokens supplied as
precomputed patch embeddings (CLIP frontend is a stub per assignment).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    pattern="A", frontend="vision", n_img_tokens=576,
)
