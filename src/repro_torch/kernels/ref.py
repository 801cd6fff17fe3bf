"""Plain PyTorch versions of the kernels — what the wrappers run on a CPU
tensor, and what the CUDA kernels are held against on the card.

ELL semantics are the kernels': padding slots (``col == -1``) and columns
at or past ``x.shape[0]`` contribute nothing; ``max_times`` starts from
-inf so signed products are not clamped, and rows with no contributing
entry resolve to 0.  (The JAX reference's oracle clamps columns past
the end to the last one instead; its Pallas kernel drops them, as here.)
"""
from __future__ import annotations

import torch

RINGS = ("plus_times", "max_times")


def _gather_products(ecols: torch.Tensor, evals: torch.Tensor,
                     x: torch.Tensor):
    """(hit, prods): per-slot validity mask and vals ⊗ x[col]; for a 2-D
    ``x`` both carry a trailing query axis."""
    hit = (ecols >= 0) & (ecols < x.shape[0])
    xg = x[torch.where(hit, ecols, 0).long()].to(torch.float32)
    if x.dim() == 2:
        hit = hit[..., None]
        prods = evals.to(torch.float32)[..., None] * xg    # (R, K, B)
    else:
        prods = evals.to(torch.float32) * xg               # (R, K)
    return hit, prods


def _reduce(hit: torch.Tensor, prods: torch.Tensor, ring: str):
    if ring == "plus_times":
        return torch.where(hit, prods, 0.0).sum(dim=1)
    if ring == "max_times":
        out = torch.where(hit, prods, -torch.inf).amax(dim=1)
        return torch.where(torch.isneginf(out), 0.0, out)
    raise ValueError(f"ring must be one of {RINGS}, got {ring!r}")


def spmv_ell_ref(ecols: torch.Tensor, evals: torch.Tensor, x: torch.Tensor,
                 ring: str = "plus_times") -> torch.Tensor:
    """y[r] = ⊕_k evals[r,k] ⊗ x[ecols[r,k]]."""
    return _reduce(*_gather_products(ecols, evals, x), ring)


def spmm_ell_ref(ecols: torch.Tensor, evals: torch.Tensor, x: torch.Tensor,
                 ring: str = "plus_times") -> torch.Tensor:
    """Y[r, j] = ⊕_k evals[r,k] ⊗ X[ecols[r,k], j]."""
    return _reduce(*_gather_products(ecols, evals, x), ring)


def segsum_ref(ids: torch.Tensor, vals: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """out[s] = Σ_{i: ids[i]==s} vals[i], summed in float32; ids outside
    [0, num_segments) (the ELL's -1 padding among them) are dropped, as
    ``jax.ops.segment_sum`` and the Pallas kernel drop them."""
    out = torch.zeros(num_segments, dtype=torch.float32, device=vals.device)
    keep = (ids >= 0) & (ids < num_segments)
    return out.index_add_(0, ids[keep].long(), vals[keep].to(torch.float32))


def spgemm_sel_ref(ecols: torch.Tensor, evals: torch.Tensor,
                   sel: torch.Tensor, ring: str = "plus_times") -> torch.Tensor:
    """Y[r, j] = ⊕_k evals[r,k] ⊗ [ecols[r,k] == sel[j]] over stored
    slots only (``ecols >= 0``): the masked column select, with the
    (R, K, B) hit mask built densely.  Under ``max_times`` only hits
    reduce, from -inf, so a column whose hits are all negative keeps its
    negative maximum; (row, j) with no hit resolves to 0."""
    if ring not in RINGS:
        raise ValueError(f"ring must be one of {RINGS}, got {ring!r}")
    if ecols.shape[1] == 0:
        return torch.zeros((ecols.shape[0], sel.shape[0]),
                           dtype=torch.float32, device=evals.device)
    hit = (ecols[..., None] == sel[None, None, :]) & (ecols[..., None] >= 0)
    vals = evals.to(torch.float32)[..., None]
    if ring == "plus_times":
        return torch.where(hit, vals, 0.0).sum(dim=1)
    out = torch.where(hit, vals, -torch.inf).amax(dim=1)
    return torch.where(torch.isneginf(out), 0.0, out)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor):
    """The RWKV-6 recurrence from a zero state: the model's own
    ``wkv_scan`` in float32.  Returns (o (B,S,H,Dh), final state
    (B,H,Dh,Dh) k-major)."""
    from ..models.blocks import wkv_scan
    b, _, h, dh = r.shape
    state0 = torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=r.device)
    return wkv_scan(*(t.to(torch.float32) for t in (r, k, v, w, u)), state0)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_0 = 0, one step at a time, in
    float32; returns ``a.dtype``.  a, b: (B, S, C)."""
    af, bf = a.to(torch.float32), b.to(torch.float32)
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    out = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: float = None) -> torch.Tensor:
    """The model's ``attention_naive`` with positions 0..S-1 for both q
    and k (the kernel derives them from indices), the scores scaled by
    ``scale`` (default Dh^-0.5).  q: (B, Sq, H, Dh); k, v: (B, Sk, KV,
    Dh)."""
    from ..models.layers import attention_naive
    b, sq = q.shape[:2]
    sk = k.shape[1]
    q_pos = torch.arange(sq, device=q.device).expand(b, sq)
    k_pos = torch.arange(sk, device=q.device).expand(b, sk)
    return attention_naive(q, k, v, q_pos, k_pos, causal, window,
                           scale=scale)
