"""Input specifications per (architecture × shape) cell — the JAX
package's ``models/inputs.py`` on PyTorch.

``input_specs`` returns ``meta`` tensors standing in for every model
input (shapes and dtypes, no storage), and ``cache_specs`` the decode
caches on ``meta``.  ``make_batch`` materializes a batch from
``np.random.default_rng(seed)``, drawing the JAX package's numbers in
its order, so both packages get equal batches.

Applicability rules:
* ``long_500k`` only for sub-quadratic archs (SSM / hybrid / SWA);
* enc-dec (whisper) skips ``long_500k`` (not sub-quadratic) and supplies
  precomputed ``enc_out`` for decode shapes;
* the audio and vision stubs take frame / patch embeddings directly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import get_device
from . import model as M
from .config import ModelConfig, ShapeConfig

META = torch.device("meta")


class SkipCell(Exception):
    """Raised when an (arch × shape) cell is architecturally undefined."""


def check_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Return a skip-reason string, or None if the cell runs."""
    if shape.name == "long_500k":
        if cfg.is_encdec:
            return ("enc-dec: source is 30s/1500 frames; 500k-token decode "
                    "is architecturally undefined")
        if not cfg.sub_quadratic:
            return ("pure full-attention arch: 500k KV cache is the "
                    "subject of a different paper (per assignment, skipped)")
    return None


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` tensors for the inputs of this cell's step function."""
    reason = check_applicable(cfg, shape)
    if reason:
        raise SkipCell(reason)
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    f32, i32 = torch.float32, torch.int32
    if shape.kind in ("train", "prefill"):
        spec = {"tokens": _spec((B, S), i32)}
        if shape.kind == "train":
            spec["labels"] = _spec((B, S), i32)
        if cfg.frontend == "vision":
            spec["img_embeds"] = _spec((B, cfg.n_img_tokens, D), f32)
        if cfg.is_encdec:
            spec["frames"] = _spec((B, cfg.encoder_seq, D), f32)
        return spec
    # decode: one new token against caches of length seq_len
    spec = {"tokens": _spec((B, 1), i32), "positions": _spec((B, 1), i32)}
    if cfg.is_encdec:
        spec["enc_out"] = _spec((B, cfg.encoder_seq, D), f32)
    return spec


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> list:
    """This cell's decode caches on ``meta`` (no allocation)."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len, META)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               device: "str | torch.device | None" = None) -> dict:
    """A concrete batch matching :func:`input_specs` on ``device``
    (default :func:`get_device`): integer inputs uniform below the vocab
    (tokens, labels) or the sequence length (positions), float inputs
    standard normal, in the specs' order."""
    dev = get_device() if device is None else torch.device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in input_specs(cfg, shape).items():
        if s.dtype.is_floating_point:
            a = rng.normal(0, 1, size=tuple(s.shape)).astype(np.float32)
        else:
            hi = cfg.vocab if k in ("tokens", "labels") else shape.seq_len
            a = rng.integers(0, hi, size=tuple(s.shape)).astype(np.int32)
        out[k] = torch.from_numpy(a).to(dev)
    return out
