"""repro_torch.checkpoint — atomic, sharded checkpoints of trees of
tensors, restorable onto any device."""
from .manager import AsyncCheckpointer, latest_step, restore, save

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]
