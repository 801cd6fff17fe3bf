"""RWKV-6 WKV recurrence (the time-mix core of the rwkv6 model family).

:func:`wkv6` computes, per (batch, head) from a zero state,

    o_t = r_t · (S + u ⊙ k_t ⊗ v_t),    S ← w_t ⊙ S + k_t ⊗ v_t

and returns the output with the final state, which the model hands to
decode.  On CUDA tensors it launches the kernel in ``csrc/wkv6.cu`` (the
chunked form, chunks of 16 steps); on CPU tensors it runs the plain
version :func:`repro_torch.kernels.ref.wkv6_ref`.
"""
from __future__ import annotations

import torch

from . import ops
from .ref import wkv6_ref

HEAD_DIMS = (8, 16, 32, 64, 128)


def check_wkv6(r, k, v, w, u) -> None:
    """Validate the kernel's inputs: float32 r, k, v, w of one
    (B, S, H, Dh) shape and strides with a unit-stride last axis, u a
    contiguous float32 (H, Dh), Dh in :data:`HEAD_DIMS`."""
    seq = (r, k, v, w)
    if any(t.dtype != torch.float32 for t in seq + (u,)):
        raise TypeError(f"wkv6 takes float32 tensors, got "
                        f"{[t.dtype for t in seq + (u,)]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in seq):
        raise ValueError(f"r, k, v, w must share one (B, S, H, Dh) shape, "
                         f"got {[tuple(t.shape) for t in seq]}")
    b, s, h, dh = r.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if u.shape != (h, dh) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous ({h}, {dh}), got "
                         f"{tuple(u.shape)}")
    if r.stride(3) != 1 or any(t.stride() != r.stride() for t in seq):
        raise ValueError(f"r, k, v, w must share strides with a unit-stride "
                         f"last axis, got {[t.stride() for t in seq]}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, S, H, Dh) float32, w the per-step decay in (0, 1);
    u: (H, Dh) bonus.  Returns (o (B, S, H, Dh), final state
    (B, H, Dh, Dh) k-major), both float32.  Any S, a ragged last chunk
    included.

    The kernel's chunked form scales by exp(±Σ log w) over a chunk of 16
    steps, with no guard: it holds float32 for w ≥ 0.004 (the model clips
    w at exp(-e^0.5) ≈ 0.1924, where the factors stay within 3e11).  That
    domain is wider than the Pallas kernel's, whose default chunk of 32
    overflows sooner (8.2e22 at the clip floor).

    Forward-only: raises where an input requires grad in grad mode
    (:func:`ops.forward_only`)."""
    check_wkv6(r, k, v, w, u)
    ops.forward_only("wkv6", r, k, v, w, u)
    if not ops.on_cuda(r, k, v, w, u):
        return wkv6_ref(r, k, v, w, u)
    b, s, h, dh = r.shape
    o = torch.empty((b, s, h, dh), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    if b * h:
        sb, st, sh, _ = r.stride()
        ops.launch("wkv6", "wkv6_forward", "wkv6", r.device,
                   r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), o.data_ptr(), state.data_ptr(), b, s, h, dh,
                   sb, st, sh)
    return o, state
