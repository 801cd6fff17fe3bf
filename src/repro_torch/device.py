"""The device every port tensor is made on.

The default is ``cuda``.  ``REPRO_TORCH_DEVICE=cpu`` (read at import) or
:func:`set_device` selects another.  There is no silent CPU fallback:
with the default in force and no card, the first device tensor raises.
The CPU runs the kernels' plain PyTorch versions (``repro_torch.kernels``
picks by the tensor's device), which is how the tests run.
"""
from __future__ import annotations

import os

import torch

_DEVICE = torch.device(os.environ.get("REPRO_TORCH_DEVICE", "cuda"))


def get_device() -> torch.device:
    return _DEVICE


def set_device(device: "str | torch.device") -> torch.device:
    """Select the device for new tensors; returns the previous one."""
    global _DEVICE
    prev, _DEVICE = _DEVICE, torch.device(device)
    return prev
