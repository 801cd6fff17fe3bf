"""The port's ModelConfig in the JAX package's schema.

The port's schema adds fields the JAX package has not: a rope for each
attention layer kind (``rope_global``, ``rope_local``) and the MoE's
``dropless`` mode.  A configuration both packages hold leaves them at
their defaults (the default rope at ``rope_theta``, capacity routing),
which :func:`as_jax_schema` checks before it leaves them out.
"""
from __future__ import annotations

import dataclasses

PORT_ONLY = {"rope_global": None, "rope_local": None}
MOE_PORT_ONLY = {"dropless": False}


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
