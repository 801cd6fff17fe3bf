"""Model blocks with init + apply, as the JAX package's ``models/blocks.py``
has them: the attention block (global and sliding-window, with a ring
cache), encoder–decoder cross-attention, the SwiGLU MLP, the
mixture-of-experts MLP, the RG-LRU recurrent block (Griffin /
recurrentgemma) and the RWKV-6 block (Finch).

Every block follows the same contract::

    params = init_<block>(cfg, gen)                  # dict of tensors
    y, new_cache = apply_<block>(params, x, ctx, cfg)

``gen`` is a ``torch.Generator``; parameters are made on its device and
stored float32, and cast to ``cfg.dtype`` at use (``_c``).  ``ctx``
carries positions, the mode, the layer's decode cache and, for
encoder–decoder models, the encoder output and its positions.  Caches:

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
from .config import ModelConfig, MoEConfig
from .shard_ctx import (constrain, local_rows, merge_heads, rows_like,
                        run_local, split_heads, tp_out)

RWKV_IMPLS = ("scan", "chunked", "pallas", "unrolled")


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
    enc_out: Optional[torch.Tensor] = None   # encoder output (cross-attn)
    enc_pos: Optional[torch.Tensor] = None


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


def head_kv_map(cfg: ModelConfig) -> torch.Tensor:
    """Physical head → physical kv-head index, preserving the LOGICAL
    GQA grouping for real heads (padded heads map to kv 0, masked); on
    the host, where a sharded attention reads it to plan each rank's
    heads (``layers._kv_heads``)."""
    groups = cfg.n_heads // cfg.n_kv_heads
    idx = torch.zeros(cfg.phys_heads, dtype=torch.int64)
    idx[:cfg.n_heads] = torch.arange(cfg.n_heads) // groups
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
    # pin the head axes to the model axis
    return (split_heads(q, H, Dh), split_heads(k, KV, Dh),
            split_heads(v, KV, Dh))


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


def _write_cache(write, cache: AttnCache, k, v, positions):
    """``write(k ring, v ring, slot positions, k, v, positions)`` → the
    new rings and slot positions, on each rank's sequences and heads
    when sharded (the writes index the ring, which DTensor has no rules
    for)."""
    heads, rows = ["batch", None, "model", None], ("batch", None)
    placements = getattr(cache.k, "placements", ())
    for axis, p in zip(getattr(getattr(cache.k, "device_mesh", None),
                               "mesh_dim_names", None) or (), placements):
        if axis == "model" and p.is_shard():
            # a ring sharded over model keeps its layout (cache_specs:
            # the kv heads, or the head dim where they do not divide)
            heads = ["batch", None, None, None]
            heads[p.dim] = "model"
    heads = tuple(heads)
    return run_local(write, (heads, heads, rows, heads, heads, rows),
                     (0, 1, 2), cache.k, cache.v, cache.pos, k, v, positions)


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
    kv_map = head_kv_map(cfg) if cfg.phys_heads != cfg.n_heads else None
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

        def write(kc, vc, pos, k, v, positions):
            kc, vc, pos = kc.clone(), vc.clone(), pos.clone()
            kc[:, slot:slot + S] = k
            vc[:, slot:slot + S] = v
            pos[:, slot:slot + S] = positions.to(torch.int32)
            return kc, vc, pos
        kc, vc, pos = _write_cache(write, cache, k, v, ctx.positions)
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

            def write(kc, vc, pos, k, v, positions):
                tail_pos = positions[:, -take:].to(torch.int32)
                slots = (tail_pos[0] % s_alloc).long()
                kc, vc, pos = kc.clone(), vc.clone(), pos.clone()
                kc[:, slots] = k[:, -take:]
                vc[:, slots] = v[:, -take:]
                pos[:, slots] = tail_pos
                return kc, vc, pos
            new_cache = AttnCache(*_write_cache(write, cache, k, v,
                                                ctx.positions), S)
    hm = head_mask(cfg, out.dtype, x.device)
    if hm is not None:   # zero padded-head outputs → exact logical math
        out = out * hm[None, None, :, None]
    return x + tp_out(merge_heads(out) @ _c(p["wo"], cfg)), new_cache


def apply_cross_attn(p: dict, x: torch.Tensor, ctx: Ctx,
                     cfg: ModelConfig) -> torch.Tensor:
    """Encoder–decoder cross-attention (whisper), pre-norm, residual out.
    K and V are recomputed from ``ctx.enc_out`` at every call (no cache),
    and the block's biases are not applied, as in the JAX package.  The
    attention is naive while the encoder output fits one
    ``attention_chunk``, else ``cfg.attention_impl``."""
    B, S, _ = x.shape
    H, KV = cfg.phys_heads, cfg.phys_kv_heads
    Dh = cfg.resolved_head_dim
    h = L.rms_norm(x, _c(p["ln"], cfg), cfg.norm_eps)
    q = split_heads(h @ _c(p["wq"], cfg), H, Dh)
    enc = ctx.enc_out
    k = split_heads(enc @ _c(p["wk"], cfg), KV, Dh)
    v = split_heads(enc @ _c(p["wv"], cfg), KV, Dh)
    kv_map = head_kv_map(cfg) if cfg.phys_heads != cfg.n_heads else None
    impl = "naive" if enc.shape[1] <= cfg.attention_chunk \
        else cfg.attention_impl
    out = L.attention(q, k, v, ctx.positions, ctx.enc_pos, causal=False,
                      impl=impl, chunk=cfg.attention_chunk, kv_map=kv_map)
    hm = head_mask(cfg, out.dtype, x.device)
    if hm is not None:
        out = out * hm[None, None, :, None]
    return x + tp_out(merge_heads(out) @ _c(p["wo"], cfg))


# =============================================================================
# MLP / MoE
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


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> dict:
    m = cfg.moe
    D, E, F_ = cfg.d_model, m.n_experts, m.d_expert
    return {
        "ln": torch.zeros((D,), dtype=torch.float32, device=gen.device),
        "router": _dense_init(gen, (D, E)),
        "w_gate": _dense_init(gen, (E, D, F_)),
        "w_up": _dense_init(gen, (E, D, F_)),
        "w_down": _dense_init(gen, (E, F_, D)),
    }


def moe_capacity(m: MoEConfig, seq_len: int) -> int:
    """Expert slots a sequence: capacity_factor · S · k / E, rounded up
    to a multiple of 8, at least 8."""
    c = int(m.capacity_factor * seq_len * m.top_k / m.n_experts)
    return max((c + 7) // 8 * 8, 8)


def _token_choice_dispatch(probs: torch.Tensor, k: int, capacity: int):
    """Sort-based token-choice routing, per sequence, batched.

    probs: (B, T, E).  Returns (slot, keep, gate), each (B, T·k) over the
    flattened (token, choice) pairs: slot = expert·C + min(rank, C−1),
    rank the pair's place among the sequence's pairs of its expert in
    flat order (a stable argsort), keep = rank < C, gate = the top-k
    probability renormalized by the top-k sum."""
    b, t, e = probs.shape
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)      # (B, T, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    flat_e = expert_ids.reshape(b, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((b, e), dtype=flat_e.dtype, device=probs.device
                         ).scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts             # (B, E)
    ranks_sorted = torch.arange(t * k, device=probs.device) - \
        torch.gather(starts, 1, sorted_e)
    ranks = torch.empty_like(ranks_sorted).scatter_(1, order, ranks_sorted)
    keep = ranks < capacity
    slot = flat_e * capacity + torch.clamp_max(ranks, capacity - 1)
    return slot, keep, gate_vals.reshape(b, t * k)


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mixture-of-experts FFN with C = :func:`moe_capacity` slots an
    expert and sequence; router logits and softmax in float32.

    ``token_choice``: each token's top-k experts
    (:func:`_token_choice_dispatch`); a pair past its expert's capacity
    is dropped (scattered into one spare row that is sliced off, and
    weighted 0 in the combine).  ``expert_choice``: each expert takes its
    top-C tokens, weighted by their probabilities.  The combine sums the
    weighted expert outputs back onto their tokens with ``index_add``.
    Every sequence routes on its own, as the JAX package's vmap does;
    here the batch is flattened into the row indices.  On batch-sharded
    DTensors each rank routes, dispatches and combines its own sequences
    (``shard_ctx.local_rows``); the expert FFN runs on the DTensors."""
    m = cfg.moe
    _, S, D = x.shape
    E, k = m.n_experts, m.top_k
    C = moe_capacity(m, S)
    dev = x.device
    h = L.rms_norm(x, _c(p["ln"], cfg), cfg.norm_eps)          # (B, S, D)
    logits = h.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                     # (B, S, E)
    # routing is per sequence: each rank routes its own sequences
    hl, probs = local_rows(h), local_rows(probs)
    B = hl.shape[0]
    h_rows = hl.reshape(B * S, D)
    seq = torch.arange(B, device=dev)[:, None]
    if m.router == "expert_choice":
        g, idx = torch.topk(probs.transpose(1, 2), C, dim=-1)  # (B, E, C)
        rows = (seq[:, :, None] * S + idx).reshape(-1)
        ye = local_rows(_expert_ffn(p, rows_like(
            h_rows.index_select(0, rows).reshape(B, E, C, D), h), cfg))
        contrib = (ye * g[..., None].to(ye.dtype)).reshape(B * E * C, D)
    else:
        slot, keep, gate = _token_choice_dispatch(probs, k, C)
        rows = (seq * S + torch.arange(S, device=dev).repeat_interleave(k)
                ).reshape(-1)                                 # (B·S·k,)
        base = seq * (E * C)
        safe = torch.where(keep, base + slot, B * E * C).reshape(-1)
        xe = hl.new_zeros((B * E * C + 1, D)).index_copy(
            0, safe, h_rows.index_select(0, rows))
        ye = local_rows(_expert_ffn(
            p, rows_like(xe[:B * E * C].reshape(B, E, C, D), h), cfg))
        contrib = ye.reshape(B * E * C, D).index_select(
            0, (base + torch.clamp_max(slot, E * C - 1)).reshape(-1))
        contrib = contrib * (gate * keep).to(contrib.dtype).reshape(-1, 1)
    out = torch.zeros((B * S, D), dtype=contrib.dtype, device=dev
                      ).index_add(0, rows, contrib)
    out = rows_like(out.reshape(B, S, D).to(x.dtype), h)
    return x + tp_out(constrain(out, "batch", None, None))


def _expert_ffn(p: dict, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, E, C, D) → (B, E, C, D): every expert's SwiGLU over its slots
    (expert-parallel over E)."""
    xe = constrain(xe, "batch", "model", None, None)
    g = torch.einsum("becd,edf->becf", xe, _c(p["w_gate"], cfg))
    u = torch.einsum("becd,edf->becf", xe, _c(p["w_up"], cfg))
    return torch.einsum("becf,efd->becd", F.silu(g) * u,
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
    # the gate products contract the model-sharded channels: keep their
    # outputs sharded over model along the channels
    r = torch.sigmoid(constrain(xc @ _c(p["wa"], cfg), "batch", None, "model"
                                ).to(torch.float32))
    i = torch.sigmoid(constrain(xc @ _c(p["wi"], cfg), "batch", None, "model"
                                ).to(torch.float32))
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
    return x + tp_out(out @ _c(p["wo"], cfg)), new_cache


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
    strict-lower-triangular (C×C) matmul pair, computed for all chunks at
    once; across chunks the state is carried by a loop of one multiply
    and add a chunk.  Intra-chunk scores factor as
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
    # every chunk at once: intra-chunk strict-causal attention, the
    # diagonal bonus r_t · (u ⊙ k_t) v_t, and the chunk's end-decayed
    # contribution to the state
    scores = torch.einsum("nbhck,nbhsk->nbhcs", q_eff, k_in) * tri
    intra = torch.einsum("nbhcs,nbhsv->nbhcv", scores, vc)
    diag = torch.einsum("nbhck,hk->nbhc", rc * kc, u)[..., None] * vc
    kv = torch.einsum("nbhsk,nbhsv->nbhkv", k_out, vc)
    decay = total.transpose(-1, -2)                          # (n,B,H,Dh,1)
    # the state entering each chunk: decay across the chunk plus its
    # contribution, carried by a loop
    state = state0
    states = []
    for i in range(n):
        states.append(state)
        state = state * decay[i] + kv[i]
    # inter-chunk: queries read the carried state through decay-in
    inter = torch.einsum("nbhck,nbhkv->nbhcv", q_eff, torch.stack(states))
    out = (inter + intra + diag).permute(1, 0, 3, 2, 4).reshape(B, S, H, Dh)
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
    else :func:`wkv_scan` in decode, for ``"scan"`` and ``"unrolled"``
    (the JAX package's Python-loop form of its scan) and for ragged S;
    else :func:`wkv_chunked`.  On sharded activations the
    recurrence runs on each rank's sequences and heads
    (``shard_ctx.run_local``)."""
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
    r = split_heads(xr @ _c(p["wr"], cfg), H, Dh)
    k = split_heads(xk @ _c(p["wk"], cfg), H, Dh)
    v = split_heads(xv @ _c(p["wv"], cfg), H, Dh)
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
        if ctx.mode == "decode" or cfg.rwkv_impl in ("scan", "unrolled") \
                or S % cfg.rwkv_chunk != 0 or S < cfg.rwkv_chunk:
            wkv = wkv_scan
        else:
            def wkv(*a):
                return wkv_chunked(*a, chunk=cfg.rwkv_chunk)
        # per sequence and head: on each rank's shards when sharded
        heads = ("batch", None, "model", None)
        out, state = run_local(wkv, (heads,) * 4 + (
            ("model", None), ("batch", "model", None, None)), (0, 5),
            rf, kf, vf, w, u, state0)
    out = out.reshape(B, S, D)
    out = L.rms_norm(out.to(x.dtype), _c(p["ln_x"], cfg), cfg.norm_eps)
    out = out * F.silu(g)
    x = x + tp_out(out @ _c(p["wo"], cfg))
    # ---- channel mix ----
    h2 = L.rms_norm(x, _c(p["ln2"], cfg), cfg.norm_eps)
    prev2 = _shift(h2, cache.shift2 if decode else None)
    mu_c = _c(p["mu_c"], cfg)
    xk2 = _ddlerp(h2, prev2, mu_c[0])
    xr2 = _ddlerp(h2, prev2, mu_c[1])
    kk = torch.square(torch.relu(xk2 @ _c(p["ck"], cfg)))
    vv = tp_out(kk @ _c(p["cv"], cfg))
    rr = torch.sigmoid(xr2 @ _c(p["cr"], cfg))
    x = x + rr * vv
    new_cache = None
    if ctx.mode in ("decode", "prefill"):
        # copies, so the cache does not keep the (B, S, D) activations
        new_cache = RWKVCache(state, h[:, -1].clone(), h2[:, -1].clone())
    return x, new_cache
