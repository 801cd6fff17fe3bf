"""Blocked online-softmax (flash) attention with causal and sliding-window
masks and grouped kv heads.

:func:`flash_attention` keeps the JAX package's public layout: q
(B, Sq, H, Dh), k and v (B, Sk, KV, Dh) with H % KV == 0, positions
0..S-1 derived from indices.  On CUDA tensors it launches the kernel in
``csrc/flash_attention.cu`` for q's dtype: bfloat16 runs on the tensor
cores (``mma.sync``), float32 on the CUDA cores; on CPU tensors it runs
the plain version :func:`repro_torch.kernels.ref.flash_attention_ref`
(the model's ``attention_naive``).
"""
from __future__ import annotations

import torch

from . import ops
from .ref import flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def check_flash_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> None:
    """Validate the kernel's inputs: q (B, Sq, H, Dh), k and v of one
    (B, Sk, KV, Dh) shape with H % KV == 0 and Sk >= 1, one dtype of
    :data:`DTYPES`, Dh a multiple of 8 up to :data:`MAX_HEAD_DIM`, each a
    unit-stride last axis; k and v 16-byte aligned (base and strides),
    which the kernel copies 16 bytes at a time."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, Dh) and k, v one "
                         f"(B, Sk, KV, Dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[2] < 1 or \
            h % k.shape[2] or k.shape[1] < 1:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: need the same batch and head "
                         f"dim, H % KV == 0 and Sk >= 1")
    if dh % 8 or not 8 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} is not a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit-stride last axis")
    for t in (k, v):
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"k and v need 16-byte aligned bases and "
                             f"strides, got stride {t.stride()} from "
                             f"address {t.data_ptr()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: float = None) -> torch.Tensor:
    """Attention of q over k, v with query i seeing key j where
    ``j <= i`` (``causal``) and ``i - j < window`` (``window`` > 0),
    the scores scaled by ``scale`` (default Dh^-0.5).  Returns
    (B, Sq, H, Dh) in q's dtype.  Forward-only: raises where an input
    requires grad in grad mode (:func:`ops.forward_only`)."""
    check_flash_attention(q, k, v)
    ops.forward_only("flash_attention", q, k, v)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if not ops.on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal, window, scale)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if o.numel():
        ops.launch("flash_attention", "flash_attention_forward",
                   "flash_attention", q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   b, sq, sk, h, kv, dh, *q.stride()[:3], *k.stride()[:3],
                   *v.stride()[:3], int(bool(causal)), int(window),
                   scale, DTYPES[q.dtype])
    return o
