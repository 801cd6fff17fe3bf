"""Core neural layers — the JAX package's ``models/layers.py`` on PyTorch.

Attention implementations, as there:

* ``naive``   — materializes (S, S) scores;
* ``chunked`` — two-level blocked online-softmax over Q and KV blocks;
* ``chunked_tri`` — the same, skipping KV blocks that are fully masked;
* ``pallas``  — the ``flash_attention`` kernel where its preconditions
  hold (:func:`_pallas_attention_ok`), else ``chunked``.

JAX's bf16 einsums with ``preferred_element_type=float32`` multiply bf16
values with float32 accumulation and a float32 result; here the operands
are upcast to float32 before the product, which computes the same
values.  The JAX package's sharding constraints are ``shard_ctx``
calls at the same sites: no-ops on plain tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from .config import RopeConfig
from .shard_ctx import (alike_steps, constrain, current_mesh, partial_over,
                        run_local, tp_out)

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 scaled by ``1 + scale``, cast back to x's
    dtype."""
    dt = x.dtype
    if x.ndim == 3:
        # the statistics need whole rows: gather a D-sharded input first
        x = constrain(x, "batch", None, None)
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    out = out.to(dt)
    if out.ndim == 3:
        # keep activations batch-sharded (not D-sharded like the weights)
        out = constrain(out, "batch", None, None)
    return out


def rope_inv_freq(r: RopeConfig, dim: int, device=None) -> torch.Tensor:
    """The (dim // 2,) float32 inverse frequencies of rope ``r`` over a
    head of ``dim``."""
    half = dim // 2
    if r.kind == "default":
        return r.theta ** (-torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half)
    if r.kind != "yarn":
        raise ValueError(f"unknown rope kind {r.kind!r}")
    pos_freqs = r.theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim)

    def dim_of(rotations: float) -> float:
        """The dimension that turns ``rotations`` times over the
        original context."""
        return dim * math.log(r.original_max_position /
                              (rotations * 2 * math.pi)) / \
            (2 * math.log(r.theta))

    low = max(math.floor(dim_of(r.beta_fast)), 0)
    high = min(math.ceil(dim_of(r.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(half, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    # 1 keeps a frequency as it is (fast dims), 0 interpolates it
    keep = 1 - ramp
    return (1.0 / (r.factor * pos_freqs)) * (1 - keep) + \
        (1.0 / pos_freqs) * keep


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: "float | RopeConfig" = 10_000.0,
         rotary_dims: int = 0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, Dh), positions: (..., S).
    ``theta`` is a default rope's base or a :class:`RopeConfig`.
    ``rotary_dims`` > 0 rotates only a head's last ``rotary_dims`` dims
    (MLA's rope part), with frequencies over that width, and keeps the
    others as they are."""
    r = theta if isinstance(theta, RopeConfig) else RopeConfig(theta=theta)
    if rotary_dims and rotary_dims != x.shape[-1]:
        keep = x.shape[-1] - rotary_dims
        return torch.cat([x[..., :keep],
                          rope(x[..., keep:], positions, r)], dim=-1)
    half = x.shape[-1] // 2
    freq = rope_inv_freq(r, x.shape[-1], x.device)
    angles = positions[..., None].to(torch.float32) * freq   # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                    # over heads
    sin = torch.sin(angles)[..., None, :]
    factor = r.cos_sin_factor
    if factor != 1.0:
        cos, sin = cos * factor, sin * factor
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _expand_kv(k: torch.Tensor, n_heads: int,
               kv_map: torch.Tensor = None) -> torch.Tensor:
    """GQA: repeat KV heads to match query heads, (B,S,KV,Dh)→(B,S,H,Dh),
    each kv head serving H/KV consecutive query heads.  ``kv_map``
    (head-padded archs) gives an explicit head→kv index."""
    if kv_map is not None:
        return k.index_select(2, kv_map.to(k.device))
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=2)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int = 0) -> torch.Tensor:
    """(…,Sq,Sk) additive float32 bias: 0 where visible, NEG_INF where
    masked.  k_pos < 0 marks invalid (unwritten ring-buffer) cache slots."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = (k_pos >= 0)[..., None, :]
    if causal:
        ok = ok & (d >= 0)
    if window:
        ok = ok & (d < window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def attention_naive(q, k, v, q_pos, k_pos, causal: bool = True,
                    window: int = 0, kv_map=None,
                    scale: float = None) -> torch.Tensor:
    """Reference attention. q: (B,Sq,H,Dh) k,v: (B,Sk,KV,Dh).  The
    scores are scaled by ``scale`` (default Dh^-0.5)."""
    h = q.shape[2]
    k = _expand_kv(k, h, kv_map)
    v = _expand_kv(v, h, kv_map)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)[:, None]
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention_decode(q, k, v, q_pos, k_pos, window: int = 0,
                     scale: float = None) -> torch.Tensor:
    """Causal attention of a decode step over the K/V rings, grouped by
    KV head: what :func:`attention_naive` returns for q (B,Sq,H,Dh) and
    rings k (B,S,KV,Dh), v (B,S,KV,Dv), H = G·KV, with its masks and
    ``scale`` (default Dh^-0.5), without repeating the rings to H heads
    or upcasting them.  Dv may be below Dh: MLA's absorbed decode reads
    one latent ring (KV = 1) as keys and its first Dv columns, a view,
    as values.

    Each ring is read once, in its dtype, as (B, S, KV·Dh) — a view.
    The queries go into a block-diagonal (B, Sq·H, KV·Dh) matrix, each
    head's row holding its query in its KV head's Dh columns and zeros
    elsewhere, so one batched product gives every head's float32 scores
    (bfloat16 operands, float32 accumulation, as the reference's
    upcast).  The mask and the softmax are float32; the probabilities
    are rounded to the ring's dtype and one batched product with the V
    ring gives (Sq·H, KV·Dh), of which each head keeps its KV head's
    block.  The zeros cost KV times the needed products; at decode that
    is H·Sq products a ring byte, so reading the rings still bounds the
    products."""
    b, sq, h, dh = q.shape
    s, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kv
    qbd = q.new_zeros((b, sq, kv, g, kv, dh))
    torch.diagonal(qbd, dim1=2, dim2=4).copy_(
        q.view(b, sq, kv, g, dh).permute(0, 1, 3, 4, 2))
    qbd = qbd.view(b, sq * h, kv * dh)
    kr, vr = k.reshape(b, s, kv * dh), v.reshape(b, s, kv * dv)
    if q.is_cuda and q.dtype == k.dtype in (torch.bfloat16, torch.float16):
        scores = torch.bmm(qbd, kr.transpose(1, 2), out_dtype=torch.float32)
    else:   # the CPU has no such overload: the upcast products are equal
        scores = torch.bmm(qbd.to(torch.float32),
                           kr.to(torch.float32).transpose(1, 2))
    scores = scores.view(b, sq, h, s) * (dh ** -0.5 if scale is None
                                         else scale)
    scores = scores + _mask_bias(q_pos, k_pos, True, window)[:, :, None]
    p = torch.softmax(scores, dim=-1).to(v.dtype).view(b, sq * h, s)
    out = torch.bmm(p, vr).view(b, sq, kv, g, kv, dv)
    return torch.diagonal(out, dim1=2, dim2=4).permute(
        0, 1, 4, 2, 3).reshape(b, sq, h, dv)


def _online_block(q_blk, k_blk, v_blk, bias, carry, scale=None):
    """One online-softmax update. q_blk:(B,Bq,H,Dh), k/v:(B,Ck,H,Dh),
    bias:(B,Bq,Ck) or broadcastable; carry=(m,l,acc)."""
    m, l, acc = carry
    scale = q_blk.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", q_blk.to(torch.float32),
                     k_blk.to(torch.float32)) * scale
    s = s + bias[:, None]                       # (B,H,Bq,Ck)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + torch.sum(p, dim=-1)
    pv = torch.einsum("bhqk,bkhd->bhqd",
                      p.to(v_blk.dtype).to(torch.float32),
                      v_blk.to(torch.float32))
    return m_new, l_new, acc * alpha[..., None] + pv


def attention_chunked(q, k, v, q_pos, k_pos, causal: bool = True,
                      window: int = 0, chunk: int = 1024,
                      triangular: bool = False, kv_map=None,
                      scale: float = None) -> torch.Tensor:
    """Blocked online-softmax attention (flash-style).

    ``triangular=True`` skips KV blocks that are fully masked (causal
    upper triangle / outside the sliding window) for each Q block.
    """
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    k = constrain(_expand_kv(k, h, kv_map), "batch", None, "model", None)
    v = constrain(_expand_kv(v, h, kv_map), "batch", None, "model", None)
    bq = min(chunk, sq)
    ck = min(chunk, sk)
    # pad ragged edges; padded K slots get k_pos = -1 (always masked) and
    # padded Q rows are sliced off the output.
    sq0 = sq
    if sq % bq:
        pad = bq - sq % bq
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad))
        sq += pad
    if sk % ck:
        pad = ck - sk % ck
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
        sk += pad
    n_q, n_k = sq // bq, sk // ck
    kb = k.reshape(b, n_k, ck, h, dh)
    vb = v.reshape(b, n_k, ck, h, dh)
    kp = k_pos.reshape(*k_pos.shape[:-1], n_k, ck)
    qb = q.reshape(b, n_q, bq, h, dh)
    qp = q_pos.reshape(*q_pos.shape[:-1], n_q, bq)

    def q_block(i, lo, hi):
        """Q block i against KV blocks [lo, hi)."""
        carry = (torch.full((b, h, bq), NEG_INF, dtype=torch.float32,
                            device=q.device),
                 torch.zeros((b, h, bq), dtype=torch.float32,
                             device=q.device),
                 torch.zeros((b, h, bq, dh), dtype=torch.float32,
                             device=q.device))
        for j in alike_steps(lo, hi, q):
            bias = _mask_bias(qp[:, i], kp[:, j], causal, window)
            carry = _online_block(qb[:, i], kb[:, j], vb[:, j], bias, carry,
                                  scale)
        _, l, acc = carry
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        return out.transpose(1, 2).to(q.dtype)          # (B,Bq,H,Dh)

    outs = []
    for i in range(n_q):
        lo, hi = 0, n_k
        if triangular:
            if causal and window:
                lo = max(0, (i * bq - window) // ck)
            if causal:
                hi = min(i * bq // ck + 1, n_k)
        outs.append(q_block(i, lo, hi))
    return torch.cat(outs, dim=1)[:, :sq0]


def attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
              window: int = 0, impl: str = "chunked", chunk: int = 1024,
              kv_map=None, scale: float = None) -> torch.Tensor:
    """Dispatch in the JAX package's order: ``pallas`` runs the
    ``flash_attention`` kernel wherever the JAX package runs its Pallas
    kernel; else ``naive`` for short sequences.  ``scale`` multiplies
    the scores (default Dh^-0.5)."""
    if impl == "pallas" and _pallas_attention_ok(q, k, chunk, kv_map):
        # the kernel's own default where no scale is given
        kw = {} if scale is None else {"scale": scale}
        return flash_attention(q, k, v, causal=causal, window=window, **kw)
    if impl not in ("naive", "chunked", "pallas", "chunked_tri"):
        raise ValueError(f"unknown attention impl {impl!r}")
    # K/V expanded to the query heads (a copy, as the forms below make),
    # then every (sequence, head) attends on its own: on each rank's
    # shards when sharded
    h = q.shape[2]
    kv_spec, idx = _kv_heads(k, h, kv_map)
    if idx is None:
        k, v = _expand_kv(k, h, kv_map), _expand_kv(v, h, kv_map)

    def core(q, k, v, q_pos, k_pos, idx):
        if idx is not None:
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        if impl == "naive" or q.shape[1] <= chunk:
            return (attention_naive(q, k, v, q_pos, k_pos, causal, window,
                                    scale=scale),)
        return (attention_chunked(q, k, v, q_pos, k_pos, causal, window,
                                  chunk=chunk,
                                  triangular=impl == "chunked_tri",
                                  scale=scale),)

    heads, rows = ("batch", None, "model", None), ("batch", None)
    return run_local(core, (heads, kv_spec, kv_spec, rows, rows, None), (0,),
                     q, k, v, q_pos, k_pos, idx)[0]


def _kv_heads(k, n_heads: int, kv_map=None):
    """How a sharded attention expands K/V to the query heads on each
    rank: (the logical spec K/V are pinned to, this rank's head → local
    kv-head index).  K/V stay sharded over model where every rank's
    query heads read only its own kv heads, else replicated; DTensor
    cannot gather along a sharded head dim.  ``(None, None)`` outside a
    sharded context (the caller expands whole)."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    if (mesh is None or getattr(mesh, "device_mesh", None) is None
            or not isinstance(k, DTensor)):
        return None, None
    kv, tp = k.shape[2], mesh.shape.get("model", 1)
    heads = torch.arange(n_heads)
    idx = kv_map.cpu() if kv_map is not None else heads // (n_heads // kv)
    if n_heads % tp:        # the query heads are replicated: all of them
        return ("batch", None, None, None), idx.to(k.device)
    per, rank = n_heads // tp, mesh.index("model") if tp > 1 else 0
    mine = idx[rank * per:(rank + 1) * per]
    if kv % tp == 0 and bool((idx // (kv // tp) == heads // per).all()):
        return (("batch", None, "model", None),
                (mine - rank * (kv // tp)).to(k.device))
    return ("batch", None, None, None), mine.to(k.device)


def _pallas_attention_ok(q, k, chunk, kv_map) -> bool:
    """Kernel preconditions, as the JAX package states them: no GQA remap
    table, block-divisible seqs, fresh contiguous positions (the kernel
    derives positions from indices — ring-buffer decode uses the naive
    path)."""
    bq = min(chunk, 256, q.shape[1])
    bk = min(chunk, 256, k.shape[1])
    return (kv_map is None and q.shape[1] > 1
            and q.shape[1] % bq == 0 and k.shape[1] % bk == 0
            and q.shape[2] % k.shape[2] == 0)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = constrain(x @ w_gate, "batch", None, "model")
    u = constrain(x @ w_up, "batch", None, "model")
    return tp_out((F.silu(g) * u) @ w_down)


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """Two-layer MLP with biases and the tanh-approximated GELU (JAX's
    ``jax.nn.gelu`` default).  No model calls it, as in the JAX
    package."""
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -100) -> torch.Tensor:
    """Token-mean CE. logits: (B,S,V) any float dtype; labels: (B,S)."""
    logits = logits.to(torch.float32)
    lse = _lse(logits)
    gold = _gold(logits, labels)
    mask = (labels != ignore_id).to(torch.float32)
    return torch.sum((lse - gold) * mask) / torch.clamp_min(mask.sum(), 1.0)


def _lse(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the vocab.  On logits sharded over the vocab (a
    DTensor) as max, shift, exp and sum, each of which DTensor reduces
    across the shards (a max and a sum of (B, S) partials) instead of
    gathering the logits whole."""
    from torch.distributed.tensor import DTensor
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    # the partial sums reduced batch-sharded (not resharded along the
    # batch over model, which the backward would have to undo)
    rows = ("batch",) + (None,) * (logits.ndim - 2)
    total = constrain(torch.sum(torch.exp(logits - m), dim=-1), *rows)
    return torch.log(total) + constrain(m[..., 0], *rows)


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The labels' logits.  On DTensor logits the gather runs on each
    rank's shard (its backward then scatters into a shard-sized buffer,
    where DTensor's own allocates the whole tensor); logits sharded over
    the vocab (``Shard`` of the last dim) gather their own columns,
    others masked to 0, and sum over the shards (a partial sum the
    caller's reduction resolves)."""
    from torch.distributed.tensor import DTensor
    idx = labels.clamp_min(0).long()
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, idx[..., None])[..., 0]
    last = logits.ndim - 1
    local = logits.to_local()
    ids = idx.to_local() if isinstance(idx, DTensor) else idx
    vocab = [d for d, p in enumerate(logits.placements) if p.is_shard(last)]
    if not vocab:
        g = torch.gather(local, -1, ids[..., None])[..., 0]
        return DTensor.from_local(g, logits.device_mesh, logits.placements,
                                  run_check=False)
    (md,) = vocab
    n = local.shape[-1]
    ids = ids - logits.device_mesh.get_local_rank(md) * n
    ok = (ids >= 0) & (ids < n)
    g = torch.gather(local, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    return constrain(partial_over(g * ok.to(g.dtype), logits, md),
                     "batch", *(None,) * (g.ndim - 1))


def chunked_cross_entropy(x: torch.Tensor, w_head: torch.Tensor,
                          labels: torch.Tensor, n_chunks: int,
                          ignore_id: int = -100,
                          valid_vocab: int = 0) -> torch.Tensor:
    """Cross-entropy without materializing full (B,S,V) logits: the
    sequence axis goes through the LM head in ``n_chunks`` chunks, each
    product in float32 (x and ``w_head`` upcast from their dtype).
    Vocab columns from ``valid_vocab`` on are masked."""
    s = x.shape[1]
    if s % n_chunks:
        raise ValueError(f"sequence length {s} is not a multiple of "
                         f"{n_chunks} chunks")
    cs = s // n_chunks
    v = w_head.shape[-1]
    pad_mask = None
    if valid_vocab and valid_vocab != v:
        pad_mask = torch.where(torch.arange(v, device=x.device) < valid_vocab,
                               0.0, -1e9)
    w = w_head.to(torch.float32)
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    n_tok = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        ls = labels[:, i * cs:(i + 1) * cs]
        logits = x[:, i * cs:(i + 1) * cs].to(torch.float32) @ w
        if pad_mask is not None:
            logits = logits + pad_mask
        lse = _lse(logits)
        gold = _gold(logits, ls)
        mask = (ls != ignore_id).to(torch.float32)
        nll = nll + torch.sum((lse - gold) * mask)
        n_tok = n_tok + mask.sum()
    return nll / torch.clamp_min(n_tok, 1.0)
