"""Carry the JAX package's model parameters into the port, so both
packages can compute on the same weights."""
from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from ..tree import tree_map
from .config import ModelConfig
from .model import check_supported


def params_from_jax(cfg: ModelConfig, np_params: dict,
                    device: "str | torch.device | None" = None) -> dict:
    """The port's parameters (see :mod:`repro_torch.models.model`) from
    the JAX package's parameter tree given as numpy arrays: ``embed``,
    ``final_norm``, ``head``, ``groups/slot<i>/...`` stacked with a
    leading axis of layer groups, and ``tail/layer<j>``.  The arrays are
    copied onto ``device`` (default :func:`get_device`)."""
    check_supported(cfg)
    dev = get_device() if device is None else torch.device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a), device=dev)

    out = {k: tensor(np_params[k]) for k in ("embed", "final_norm", "head")
           if k in np_params}
    period = len(cfg.pattern)
    n_grouped = cfg.n_layers // period * period
    layers = []
    for li in range(cfg.n_layers):
        if li < n_grouped:
            group, slot = divmod(li, period)
            layer = tree_map(lambda a, g=group: np.asarray(a)[g],
                             np_params["groups"][f"slot{slot}"])
        else:
            layer = np_params["tail"][f"layer{li - n_grouped}"]
        layers.append(tree_map(tensor, layer))
    out["layers"] = layers
    return out
