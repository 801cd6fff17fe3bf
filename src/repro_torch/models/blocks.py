"""Model blocks with init + apply, as the JAX package's ``models/blocks.py``
has them: the attention block (global and sliding-window, with a ring
cache), the SwiGLU MLP, the RG-LRU recurrent block (Griffin /
recurrentgemma) and the RWKV-6 block (Finch).

Every block follows the same contract::

    params = init_<block>(cfg, gen)                  # dict of tensors
    y, new_cache = apply_<block>(params, x, ctx, cfg)

``gen`` is a ``torch.Generator``; parameters are made on its device and
stored float32, and cast to ``cfg.dtype`` at use (``_c``).  ``ctx``
carries positions, the mode and the layer's decode cache.  Caches:

* attention — (B, S_alloc, KV, Dh) K and V rings, the absolute position
  of every slot (-1 = empty) and the next write index (a Python int);
* RG-LRU — the (B, Dr) float32 state and the (B, conv_w-1, Dr) conv
  tail;
* RWKV — the (B, H, Dh, Dh) wkv state (k-major) and the (B, D)
  token-shift states of the two mixes.

Caches are updated out of place, as in JAX: a new cache is returned and
the one passed in is left as it was.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from ..kernels.rglru import rglru_scan
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
    # this layer's cache (decode)
    cache: Optional[Union["AttnCache", "RGLRUCache", "RWKVCache"]] = None


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _c(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:  # compute cast
    return x.to(compute_dtype(cfg))


# =============================================================================
# Attention block (A = global, L = sliding window)
# =============================================================================

def init_attn(cfg: ModelConfig, gen: torch.Generator) -> dict:
    D = cfg.d_model
    H, KV = cfg.phys_heads, cfg.phys_kv_heads
    Dh = cfg.resolved_head_dim
    dev = gen.device
    p = {
        "ln": torch.zeros((D,), dtype=torch.float32, device=dev),
        "wq": _dense_init(gen, (D, H * Dh)),
        "wk": _dense_init(gen, (D, KV * Dh)),
        "wv": _dense_init(gen, (D, KV * Dh)),
        "wo": _dense_init(gen, (H * Dh, D)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((n * Dh,), dtype=torch.float32, device=dev)
    return p


def head_kv_map(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Physical head → physical kv-head index, preserving the LOGICAL
    GQA grouping for real heads (padded heads map to kv 0, masked)."""
    groups = cfg.n_heads // cfg.n_kv_heads
    idx = torch.zeros(cfg.phys_heads, dtype=torch.int64, device=device)
    idx[:cfg.n_heads] = torch.arange(cfg.n_heads, device=device) // groups
    return idx


def head_mask(cfg: ModelConfig, dtype, device=None):
    """(H_phys,) 1 for real heads, 0 for padding, or None without head
    padding."""
    if cfg.phys_heads == cfg.n_heads:
        return None
    return (torch.arange(cfg.phys_heads, device=device) < cfg.n_heads
            ).to(dtype)


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KV = cfg.phys_heads, cfg.phys_kv_heads
    Dh = cfg.resolved_head_dim
    q = x @ _c(p["wq"], cfg)
    k = x @ _c(p["wk"], cfg)
    v = x @ _c(p["wv"], cfg)
    if "bq" in p:
        q = q + _c(p["bq"], cfg)
        k = k + _c(p["bk"], cfg)
        v = v + _c(p["bv"], cfg)
    return (q.reshape(B, S, H, Dh), k.reshape(B, S, KV, Dh),
            v.reshape(B, S, KV, Dh))


class AttnCache(NamedTuple):
    k: torch.Tensor       # (B, S_alloc, KV, Dh) ring buffer
    v: torch.Tensor
    pos: torch.Tensor     # (B, S_alloc) int32 absolute positions; -1 = empty
    index: int            # next global write position


def init_attn_cache(cfg: ModelConfig, batch: int, s_max: int,
                    device: torch.device, window: int = 0) -> AttnCache:
    """Sliding-window layers allocate only ``window`` slots (a ring)."""
    KV, Dh = cfg.phys_kv_heads, cfg.resolved_head_dim
    s_alloc = min(window, s_max) if window else s_max
    dt = compute_dtype(cfg)
    return AttnCache(
        torch.zeros((batch, s_alloc, KV, Dh), dtype=dt, device=device),
        torch.zeros((batch, s_alloc, KV, Dh), dtype=dt, device=device),
        torch.full((batch, s_alloc), -1, dtype=torch.int32, device=device),
        0)


def apply_attn(p: dict, x: torch.Tensor, ctx: Ctx, cfg: ModelConfig,
               window: int = 0):
    """Self-attention sublayer (pre-norm). Returns (residual_out, cache).

    Decode writes the step's K/V at ring slot ``index % S_alloc`` and
    attends naively over the ring by the slots' absolute positions;
    prefill runs ``cfg.attention_impl`` and writes each position p of the
    prompt's tail to slot p % S_alloc (taken from batch row 0), so decode
    continues the ring seamlessly."""
    h = L.rms_norm(x, _c(p["ln"], cfg), cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)
    kv_map = head_kv_map(cfg, x.device) \
        if cfg.phys_heads != cfg.n_heads else None
    q = L.rope(q, ctx.positions, cfg.rope_theta)
    k = L.rope(k, ctx.positions, cfg.rope_theta)
    B, S = x.shape[:2]
    new_cache = None
    if ctx.mode == "decode":
        cache: AttnCache = ctx.cache
        s_alloc = cache.k.shape[1]
        # the slot JAX's dynamic_update_slice writes at (start clamped so
        # the S new entries fit)
        slot = max(0, min(cache.index % s_alloc, s_alloc - S))
        kc, vc, pos = cache.k.clone(), cache.v.clone(), cache.pos.clone()
        kc[:, slot:slot + S] = k
        vc[:, slot:slot + S] = v
        pos[:, slot:slot + S] = ctx.positions.to(torch.int32)
        new_cache = AttnCache(kc, vc, pos, cache.index + S)
        # ring entries carry absolute positions; -1 slots stay masked
        out = L.attention(q, kc, vc, ctx.positions, pos, causal=True,
                          window=window, impl="naive", kv_map=kv_map)
    else:
        out = L.attention(q, k, v, ctx.positions, ctx.positions,
                          causal=True, window=window,
                          impl=cfg.attention_impl, chunk=cfg.attention_chunk,
                          kv_map=kv_map)
        if ctx.mode == "prefill" and ctx.cache is not None:
            cache = ctx.cache
            s_alloc = cache.k.shape[1]
            take = min(s_alloc, S)
            tail_pos = ctx.positions[:, -take:].to(torch.int32)
            slots = (tail_pos[0] % s_alloc).long()
            kc, vc, pos = cache.k.clone(), cache.v.clone(), cache.pos.clone()
            kc[:, slots] = k[:, -take:]
            vc[:, slots] = v[:, -take:]
            pos[:, slots] = tail_pos
            new_cache = AttnCache(kc, vc, pos, S)
    hm = head_mask(cfg, out.dtype, x.device)
    if hm is not None:   # zero padded-head outputs → exact logical math
        out = out * hm[None, None, :, None]
    return x + out.reshape(B, S, -1) @ _c(p["wo"], cfg), new_cache


# =============================================================================
# MLP
# =============================================================================

def init_mlp(cfg: ModelConfig, gen: torch.Generator) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "ln": torch.zeros((D,), dtype=torch.float32, device=gen.device),
        "w_gate": _dense_init(gen, (D, F_)),
        "w_up": _dense_init(gen, (D, F_)),
        "w_down": _dense_init(gen, (F_, D)),
    }


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(x, _c(p["ln"], cfg), cfg.norm_eps)
    return x + L.swiglu(h, _c(p["w_gate"], cfg), _c(p["w_up"], cfg),
                        _c(p["w_down"], cfg))


# =============================================================================
# RG-LRU recurrent block (Griffin / recurrentgemma)
# =============================================================================

def init_rglru(cfg: ModelConfig, gen: torch.Generator) -> dict:
    D, Dr, W = cfg.d_model, cfg.d_rnn_resolved, cfg.conv_width
    dev = gen.device
    return {
        "ln": torch.zeros((D,), dtype=torch.float32, device=dev),
        "wx": _dense_init(gen, (D, Dr)),
        "wg": _dense_init(gen, (D, Dr)),
        "conv_k": _dense_init(gen, (W, Dr), scale=W ** -0.5),
        "conv_b": torch.zeros((Dr,), dtype=torch.float32, device=dev),
        "wa": _dense_init(gen, (Dr, Dr)),      # recurrence gate
        "wi": _dense_init(gen, (Dr, Dr)),      # input gate
        "lam": torch.linspace(0.9, 5.0, Dr, dtype=torch.float32,
                              device=dev),     # Λ
        "wo": _dense_init(gen, (Dr, D)),
    }


class RGLRUCache(NamedTuple):
    h: torch.Tensor       # (B, Dr) float32 hidden state
    conv: torch.Tensor    # (B, conv_w-1, Dr) conv tail


def init_rglru_cache(cfg: ModelConfig, batch: int,
                     device: torch.device) -> RGLRUCache:
    Dr = cfg.d_rnn_resolved
    return RGLRUCache(
        torch.zeros((batch, Dr), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.conv_width - 1, Dr),
                    dtype=compute_dtype(cfg), device=device))


def _rglru_gates(p: dict, xc: torch.Tensor, cfg: ModelConfig):
    """Decay ``a`` and gated input ``b`` of the linear recurrence, both
    float32."""
    c_const = 8.0
    r = torch.sigmoid((xc @ _c(p["wa"], cfg)).to(torch.float32))
    i = torch.sigmoid((xc @ _c(p["wi"], cfg)).to(torch.float32))
    log_a = -c_const * F.softplus(p["lam"]) * r              # (..., Dr)
    a = torch.exp(log_a)
    # sqrt(1-a²) normalization keeps the state scale input-independent
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) * \
        (i * xc.to(torch.float32))
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan h_t = a_t h_{t-1} + b_t from h_0 = 0 along axis 1,
    by log-depth doubling (the plain path's counterpart of JAX's
    ``associative_scan`` over the affine maps (a, b))."""
    S = a.shape[1]
    av, bv = a, b
    shift = 1
    while shift < S:
        a_prev = torch.cat([torch.ones_like(av[:, :shift]),
                            av[:, :-shift]], dim=1)
        b_prev = torch.cat([torch.zeros_like(bv[:, :shift]),
                            bv[:, :-shift]], dim=1)
        av, bv = av * a_prev, bv + av * b_prev
        shift *= 2
    return bv


def apply_rglru(p: dict, x: torch.Tensor, ctx: Ctx, cfg: ModelConfig):
    """Griffin recurrent block: proj → causal conv → RG-LRU → gated out.

    The recurrence runs, in the JAX package's branch order: the one-step
    update in decode with S == 1; the rglru_scan kernel in prefill with
    ``rglru_impl="pallas"``; else :func:`linear_scan` from a zero state
    (decode with S > 1 included, as in JAX).  Prefill builds the cache
    only for S > 1, as JAX does."""
    B, S, _ = x.shape
    h_in = L.rms_norm(x, _c(p["ln"], cfg), cfg.norm_eps)
    xb = h_in @ _c(p["wx"], cfg)
    gate = h_in @ _c(p["wg"], cfg)
    W = cfg.conv_width
    new_cache = None
    if ctx.mode == "decode":
        cache: RGLRUCache = ctx.cache
        conv_in = torch.cat([cache.conv, xb], dim=1)          # (B, W-1+S, Dr)
        new_tail = conv_in[:, -(W - 1):]
    else:
        conv_in = F.pad(xb, (0, 0, W - 1, 0))
        # prefill: keep the last W-1 inputs so decode continues the conv
        new_tail = conv_in[:, -(W - 1):] if W > 1 else \
            torch.zeros((B, 0, xb.shape[-1]), dtype=xb.dtype,
                        device=xb.device)
    # copied, so the cache does not keep the (B, S, Dr) activations
    new_tail = new_tail.clone()
    xc = sum(conv_in[:, i:i + S] * _c(p["conv_k"][i], cfg)
             for i in range(W)) + _c(p["conv_b"], cfg)
    a, b = _rglru_gates(p, xc, cfg)
    if ctx.mode == "decode" and S == 1:
        h_new = a[:, 0] * ctx.cache.h + b[:, 0]               # (B, Dr)
        states = h_new[:, None]
        new_cache = RGLRUCache(h_new, new_tail)
    elif cfg.rglru_impl == "pallas" and ctx.mode == "prefill":
        states = rglru_scan(a, b)
    else:
        states = linear_scan(a, b)
    if ctx.mode == "prefill" and new_cache is None and S > 1:
        new_cache = RGLRUCache(states[:, -1].clone(), new_tail)
    out = states.to(x.dtype) * F.gelu(gate, approximate="tanh")
    return x + out @ _c(p["wo"], cfg), new_cache


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
    # the decay LoRA runs in f32 on the uncast weights (promoted to f32
    # where the trainer's gather_dtype cast them, as JAX promotes)
    f32 = torch.float32
    dw = p["dw_bias"] + torch.tanh(xw.to(f32) @ p["dw_a"].to(f32)) \
        @ p["dw_b"].to(f32)
    # clip keeps the chunked form's exp(±Σ log w) inside f32 range
    w = torch.exp(-torch.exp(torch.clamp_max(dw, 0.5))).reshape(B, S, H, Dh)
    rf, kf, vf, u = (t.to(torch.float32) for t in (r, k, v, p["u"]))
    if cfg.rwkv_impl == "pallas" and ctx.mode == "prefill" and \
            S % cfg.rwkv_chunk == 0 and S >= cfg.rwkv_chunk:
        # the kernel starts from a zero state and returns the final one
        out, state = wkv6(rf, kf, vf, w, u)
    else:
        state0 = cache.wkv if decode else torch.zeros(
            (B, H, Dh, Dh), dtype=torch.float32, device=x.device)
        if ctx.mode == "decode" or cfg.rwkv_impl == "scan" or \
                S % cfg.rwkv_chunk != 0 or S < cfg.rwkv_chunk:
            out, state = wkv_scan(rf, kf, vf, w, u, state0)
        else:
            out, state = wkv_chunked(rf, kf, vf, w, u, state0,
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
