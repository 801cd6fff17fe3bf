"""Model blocks with init + apply, as the JAX package's ``models/blocks.py``
has them.  Only the RWKV-6 block (Finch: data-dependent decay time-mix
plus channel-mix) is ported so far.

Every block follows the same contract::

    params = init_<block>(cfg, gen)                  # dict of tensors
    y, new_cache = apply_<block>(params, x, ctx, cfg)

``gen`` is a ``torch.Generator``; parameters are made on its device and
stored float32, and cast to ``cfg.dtype`` at use (``_c``).  ``ctx``
carries positions, the mode and the layer's decode cache.  The RWKV
cache is the (B, H, Dh, Dh) wkv state (k-major) and the (B, D)
token-shift states of the two mixes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels.wkv6 import wkv6
from . import layers as L
from .config import ModelConfig

RWKV_IMPLS = ("scan", "chunked", "pallas")


def _dense_init(gen: torch.Generator, shape, scale=None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale or fan_in ** -0.5
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).mul_(scale)


@dataclasses.dataclass
class Ctx:
    positions: torch.Tensor           # (B, S) absolute positions
    mode: str = "train"               # train | prefill | decode
    cache: Optional["RWKVCache"] = None   # this layer's cache (decode)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _c(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:  # compute cast
    return x.to(compute_dtype(cfg))


# =============================================================================
# RWKV-6 block (Finch): data-dependent decay time-mix + channel-mix
# =============================================================================

def init_rwkv(cfg: ModelConfig, gen: torch.Generator) -> dict:
    D, F_, Lw = cfg.d_model, cfg.d_ff, cfg.decay_lora
    H = cfg.n_heads
    Dh = D // H
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "ln1": full((D,), 0.0),
        # token-shift lerp coefficients for r,k,v,w,g
        "mu": full((5, D), 0.5),
        "wr": _dense_init(gen, (D, D)),
        "wk": _dense_init(gen, (D, D)),
        "wv": _dense_init(gen, (D, D)),
        "wgate": _dense_init(gen, (D, D)),
        # data-dependent decay LoRA: w = exp(-exp(bias + tanh(x A) B))
        "dw_a": _dense_init(gen, (D, Lw)),
        "dw_b": _dense_init(gen, (Lw, D), scale=0.01),
        "dw_bias": full((D,), -6.0),
        "u": full((H, Dh), 0.0),                        # bonus
        "ln_x": full((D,), 0.0),
        "wo": _dense_init(gen, (D, D)),
        # channel mix
        "ln2": full((D,), 0.0),
        "mu_c": full((2, D), 0.5),
        "ck": _dense_init(gen, (D, F_)),
        "cv": _dense_init(gen, (F_, D)),
        "cr": _dense_init(gen, (D, D)),
    }


class RWKVCache(NamedTuple):
    wkv: torch.Tensor       # (B, H, Dh, Dh) state (k-major)
    shift1: torch.Tensor    # (B, D) last token (time-mix shift)
    shift2: torch.Tensor    # (B, D) last token (channel-mix shift)


def init_rwkv_cache(cfg: ModelConfig, batch: int,
                    device: torch.device) -> RWKVCache:
    D, H = cfg.d_model, cfg.n_heads
    Dh = D // H
    dt = compute_dtype(cfg)
    return RWKVCache(
        torch.zeros((batch, H, Dh, Dh), dtype=torch.float32, device=device),
        torch.zeros((batch, D), dtype=dt, device=device),
        torch.zeros((batch, D), dtype=dt, device=device))


def wkv_scan(r, k, v, w, u, state0):
    """Reference WKV recurrence (also the decode step).

    r,k,v: (B,S,H,Dh); w: (B,S,H,Dh) decay in (0,1); u: (H,Dh) bonus.
    state: (B,H,Dh_k,Dh_v).  out_t = r_t · (state + u⊙k_t ⊗ v_t).
    Returns (out (B,S,H,Dh), final state).
    """
    state = state0
    uk = u[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,Dh,Dh)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + uk * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


def wkv_chunked(r, k, v, w, u, state0, chunk: int = 32):
    """Chunked-parallel WKV (matmul form), matching :func:`wkv_scan` to
    fp32 tolerance.

    Splits S into chunks of C; within a chunk the causal interaction is a
    strict-lower-triangular (C×C) matmul pair; across chunks the state is
    carried by a loop.  Intra-chunk scores factor as
    ``(r_t ⊙ Πw_{<t}) · (k_s ⊘ Πw_{≤s})`` — the second factor grows like
    exp(|Σ log w|) over a chunk, so apply_rwkv clips the log-decay and C
    stays ≤ 32 to keep it inside f32 range.
    """
    B, S, H, Dh = r.shape
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {C}")
    n = S // C

    def reshape(t):  # (B,S,H,Dh) → (n,B,H,C,Dh)
        return t.reshape(B, n, C, H, Dh).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(reshape, (r, k, v, w))
    logw = torch.log(torch.clamp_min(wc, 1e-38))             # (n,B,H,C,Dh)
    cum = torch.cumsum(logw, dim=3)                          # inclusive Πw_{≤t}
    q_eff = rc * torch.exp(cum - logw)                       # r_t ⊙ Πw_{<t}
    k_in = kc * torch.exp(-cum)                              # k_s ⊘ Πw_{≤s}
    total = torch.exp(cum[:, :, :, -1:, :])                  # full-chunk decay
    k_out = kc * torch.exp(cum[:, :, :, -1:, :] - cum)       # decay s→chunk end
    tri = torch.tril(torch.ones((C, C), dtype=torch.float32,
                                device=r.device), -1)
    state = state0
    outs = []
    for i in range(n):
        qe, vq = q_eff[i], vc[i]
        # inter-chunk: queries read the carried state through decay-in
        inter = torch.einsum("bhck,bhkv->bhcv", qe, state)
        # intra-chunk strict-causal attention
        scores = torch.einsum("bhck,bhsk->bhcs", qe, k_in[i]) * tri
        intra = torch.einsum("bhcs,bhsv->bhcv", scores, vq)
        # diagonal bonus: r_t · (u ⊙ k_t) v_t
        diag = torch.einsum("bhck,hk->bhc", rc[i] * kc[i], u)[..., None] * vq
        outs.append(inter + intra + diag)
        # state: decay across the chunk + end-decayed contributions
        state = state * total[i].transpose(-1, -2) + \
            torch.einsum("bhsk,bhsv->bhkv", k_out[i], vq)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, Dh)
    return out, state


def _ddlerp(x, xprev, mu):
    return x + (xprev - x) * mu


def _shift(h: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """The previous token of every position: ``last`` (the cache's) or
    zeros before the first."""
    first = torch.zeros_like(h[:, :1]) if last is None else last[:, None]
    return torch.cat([first, h[:, :-1]], dim=1)


def apply_rwkv(p: dict, x: torch.Tensor, ctx: Ctx, cfg: ModelConfig):
    """RWKV-6 time-mix + channel-mix (pre-norm residual pair).

    The WKV runs, in the JAX package's branch order: the wkv6 kernel
    (``rwkv_impl="pallas"``, prefill, S a multiple of ``rwkv_chunk``);
    else :func:`wkv_scan` in decode, for ``"scan"`` and for ragged S;
    else :func:`wkv_chunked`."""
    if cfg.rwkv_impl not in RWKV_IMPLS:
        raise NotImplementedError(f"rwkv_impl={cfg.rwkv_impl!r}: the port "
                                  f"has {RWKV_IMPLS}")
    B, S, D = x.shape
    H = cfg.n_heads
    Dh = D // H
    cache: Optional[RWKVCache] = ctx.cache
    decode = ctx.mode == "decode" and cache is not None
    # ---- time mix ----
    h = L.rms_norm(x, _c(p["ln1"], cfg), cfg.norm_eps)
    prev = _shift(h, cache.shift1 if decode else None)
    mu = _c(p["mu"], cfg)
    xr, xk, xv, xw, xg = (_ddlerp(h, prev, mu[i]) for i in range(5))
    r = (xr @ _c(p["wr"], cfg)).reshape(B, S, H, Dh)
    k = (xk @ _c(p["wk"], cfg)).reshape(B, S, H, Dh)
    v = (xv @ _c(p["wv"], cfg)).reshape(B, S, H, Dh)
    g = xg @ _c(p["wgate"], cfg)
    # the decay LoRA runs in f32 on the uncast weights
    dw = p["dw_bias"] + torch.tanh(xw.to(torch.float32) @ p["dw_a"]) \
        @ p["dw_b"]
    # clip keeps the chunked form's exp(±Σ log w) inside f32 range
    w = torch.exp(-torch.exp(torch.clamp_max(dw, 0.5))).reshape(B, S, H, Dh)
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    if cfg.rwkv_impl == "pallas" and ctx.mode == "prefill" and \
            S % cfg.rwkv_chunk == 0 and S >= cfg.rwkv_chunk:
        # the kernel starts from a zero state and returns the final one
        out, state = wkv6(rf, kf, vf, w, p["u"])
    else:
        state0 = cache.wkv if decode else torch.zeros(
            (B, H, Dh, Dh), dtype=torch.float32, device=x.device)
        if ctx.mode == "decode" or cfg.rwkv_impl == "scan" or \
                S % cfg.rwkv_chunk != 0 or S < cfg.rwkv_chunk:
            out, state = wkv_scan(rf, kf, vf, w, p["u"], state0)
        else:
            out, state = wkv_chunked(rf, kf, vf, w, p["u"], state0,
                                     chunk=cfg.rwkv_chunk)
    out = out.reshape(B, S, D)
    out = L.rms_norm(out.to(x.dtype), _c(p["ln_x"], cfg), cfg.norm_eps)
    out = out * F.silu(g)
    x = x + out @ _c(p["wo"], cfg)
    # ---- channel mix ----
    h2 = L.rms_norm(x, _c(p["ln2"], cfg), cfg.norm_eps)
    prev2 = _shift(h2, cache.shift2 if decode else None)
    mu_c = _c(p["mu_c"], cfg)
    xk2 = _ddlerp(h2, prev2, mu_c[0])
    xr2 = _ddlerp(h2, prev2, mu_c[1])
    kk = torch.square(torch.relu(xk2 @ _c(p["ck"], cfg)))
    vv = kk @ _c(p["cv"], cfg)
    rr = torch.sigmoid(xr2 @ _c(p["cr"], cfg))
    x = x + rr * vv
    new_cache = None
    if ctx.mode in ("decode", "prefill"):
        # copies, so the cache does not keep the (B, S, D) activations
        new_cache = RWKVCache(state, h[:, -1].clone(), h2[:, -1].clone())
    return x, new_cache
