"""whisper-large-v3 — encoder-decoder audio backbone (conv frontend stub).

[arXiv:2212.04356; unverified]  32 encoder + 32 decoder layers,
d_model=1280 20H (MHA kv=20) d_ff=5120 vocab=51866; encoder consumes
1500 precomputed frame embeddings (the conv frontend is a stub per the
assignment).  Adaptations: RoPE replaces whisper's learned positions
(documented in DESIGN.md) which also defines decode_32k extrapolation.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866,
    pattern="A",
    encoder_layers=32, encoder_seq=1500,
    cross_attention=True, frontend="audio",
    # H=20 doesn't divide tp=16 → pad to 32 physical heads (outputs of
    # padded heads hard-masked; math exactly the 20-head model). 16×
    # attention-flop replication without this (launch/calibrate.py).
    head_pad=32, kv_pad=32,
)
