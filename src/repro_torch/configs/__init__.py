"""Architecture registry: ``get_config(arch)`` / ``smoke_config(arch)``.

One module per assigned architecture (exact public configs, sources in
each file, the JAX package's data copied); ``smoke_config`` returns a
reduced same-family config for CPU tests (small dims, few
layers/experts).  ``ARCHS`` are the JAX package's ten, which the tests
that walk the registry compare with it; ``PORT_ARCHS`` are served by
the port alone (a configuration the JAX package has not).
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig, MoEConfig

ARCHS = (
    "recurrentgemma_9b",
    "h2o_danube_1_8b",
    "qwen2_5_14b",
    "phi3_mini_3_8b",
    "internlm2_20b",
    "whisper_large_v3",
    "granite_moe_3b_a800m",
    "qwen3_moe_235b_a22b",
    "rwkv6_1_6b",
    "phi_3_vision_4_2b",
)
PORT_ARCHS = ("mellum2_12b_a2_5b",)

# accept dashed ids from the assignment table too
_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "recurrentgemma-9b": "recurrentgemma_9b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2.5-14b": "qwen2_5_14b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "internlm2-20b": "internlm2_20b",
    "whisper-large-v3": "whisper_large_v3",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
})
_PORT_ALIASES = {
    "mellum2-12b-a2.5b": "mellum2_12b_a2_5b",
    "Mellum2-12B-A2.5B-Instruct": "mellum2_12b_a2_5b",
}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, _PORT_ALIASES.get(arch, arch))


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{canonical(arch)}", __package__)
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: ~1M params, CPU-friendly."""
    cfg = get_config(arch)
    n_layers = max(2 * len(cfg.pattern) + (1 if len(cfg.pattern) > 1 else 0),
                   2)
    moe = None
    if cfg.moe is not None:
        # ample capacity: capacity drops are data-dependent and would
        # desynchronize teacher-forcing vs decode in consistency tests
        moe = MoEConfig(n_experts=4, top_k=2, d_expert=32,
                        capacity_factor=4.0, router=cfg.moe.router,
                        dropless=cfg.moe.dropless)
    kv = max(1, 4 * cfg.n_kv_heads // cfg.n_heads)
    # a YaRN rope's original context cut to the smoke window, so a smoke
    # prompt runs past it as the served contexts run past the published
    # one and the interpolated frequencies matter
    ropes = {k: dataclasses.replace(r, original_max_position=16)
             for k, r in (("rope_global", cfg.rope_global),
                          ("rope_local", cfg.rope_local))
             if r is not None and r.kind == "yarn"}
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=64, n_heads=4, n_kv_heads=kv,
        head_dim=16, d_ff=128, vocab=256, moe=moe, window=16,
        encoder_layers=2 if cfg.is_encdec else 0, encoder_seq=24,
        n_img_tokens=8, d_rnn=64, decay_lora=8, attention_chunk=16,
        head_pad=0, kv_pad=0,
        rwkv_chunk=8, dtype="float32", **ropes)
