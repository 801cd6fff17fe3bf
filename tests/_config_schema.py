"""The port's ModelConfig in the JAX package's schema.

The port's schema adds fields the JAX package has not: a rope for each
attention layer kind (``rope_global``, ``rope_local``), leading dense
layers (``first_dense``), latent attention's widths, and the MoE's
``dropless`` mode, gate normalization and shared experts.  A
configuration both packages hold leaves them at their defaults (the
default rope at ``rope_theta``, no dense lead, no latent attention,
capacity routing with renormalized gates and no shared experts), which
:func:`as_jax_schema` checks before it leaves them out.
"""
from __future__ import annotations

import dataclasses

PORT_ONLY = {"rope_global": None, "rope_local": None, "first_dense": 0,
             "kv_lora_rank": 0, "qk_nope_head_dim": 0,
             "qk_rope_head_dim": 0, "v_head_dim": 0}
MOE_PORT_ONLY = {"dropless": False, "norm_topk_prob": True, "d_shared": 0}


def port_config(jcfg):
    """The port's ModelConfig of a JAX package's config (its fields
    carried over, the port-only ones at their defaults); the JAX
    package's code reads it as its own."""
    from repro_torch.models.config import ModelConfig, MoEConfig
    d = dataclasses.asdict(jcfg)
    moe = d.pop("moe")
    return ModelConfig(**d, moe=moe and MoEConfig(**moe))


def as_jax_schema(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    for key, default in PORT_ONLY.items():
        assert d.pop(key) == default, (cfg.name, key)
    if d["moe"] is not None:
        for key, default in MOE_PORT_ONLY.items():
            assert d["moe"].pop(key) == default, (cfg.name, key)
    return d
