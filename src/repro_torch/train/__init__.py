"""repro_torch.train — AdamW, the train step with data parallelism over
``torch.distributed``, the int8 cross-pod mean and the sharding rules
(the JAX package's ``train`` on PyTorch)."""
from . import sharding
from .compression import compressed_pod_mean
from .optimizer import OptConfig, adamw_init, adamw_update
from .trainer import (abstract_train_state, init_train_state,
                      make_decode_step, make_loss_fn, make_prefill_step,
                      make_train_step)

__all__ = [
    "sharding", "compressed_pod_mean", "OptConfig", "adamw_init", "adamw_update",
    "make_train_step", "make_loss_fn", "make_prefill_step",
    "make_decode_step", "init_train_state", "abstract_train_state",
]
