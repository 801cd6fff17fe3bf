"""repro_torch.models — the JAX package's model zoo on PyTorch: every
family of its registry."""
from . import blocks, inputs, layers, model
from .config import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                     TRAIN_4K, ModelConfig, MoEConfig, RopeConfig,
                     ShapeConfig,
                     shape_by_name)
from .interop import params_from_jax, params_from_published
from .model import (abstract_params, decode_step, forward, init_cache,
                    init_params, logits_from_hidden, loss_fn, prefill)

__all__ = [
    "ModelConfig", "MoEConfig", "RopeConfig", "ShapeConfig", "ALL_SHAPES",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K", "shape_by_name",
    "init_params", "abstract_params", "forward", "logits_from_hidden",
    "loss_fn", "prefill",
    "decode_step", "init_cache", "params_from_jax", "params_from_published",
    "layers", "blocks",
    "model", "inputs",
]
