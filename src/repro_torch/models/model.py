"""Model assembly: init, forward, prefill/decode — the JAX package's
``models/model.py`` on PyTorch, for every family of its registry: global
and sliding-window attention (``A``, ``L``) with a SwiGLU or a
mixture-of-experts MLP, encoder–decoder cross-attention and a vision
prefix, RG-LRU with a SwiGLU MLP (``R``) and RWKV-6 (``W``).  An unknown
block type raises ``NotImplementedError``.

Parameters are a dict: ``embed`` (V, D), ``final_norm`` (D,), ``head``
(D, V) unless tied, ``layers``, one dict per layer (``{"attn": ...,
"mlp": ...}`` with ``"cross"`` in an encoder–decoder, ``{"rglru": ...,
"mlp": ...}`` or ``{"rwkv": ...}``), and where the config has them
``encoder`` (``{"layers": [...], "final_norm": ...}``) and ``img_proj``
(D, D) — the JAX package's layer groups stacked for ``lax.scan`` become
lists walked by a Python loop.  Decode caches are a list with one entry
per decoder layer, likewise; cross-attention keeps no cache.

Inputs beside ``tokens`` (see :mod:`repro_torch.models.inputs`):
``img_embeds`` (B, n_img_tokens, D), projected and put before the
tokens, then dropped before the head; ``frames`` (B, encoder_seq, D),
run through the non-causal encoder (:func:`_encode`); or, in decode,
``enc_out``, an encoder output given as it is.

Modes:
* ``train``   — full-sequence forward; :func:`loss_fn` adds the
  next-token cross-entropy.  ``cfg.remat`` "block" recomputes each layer
  in the backward (``torch.utils.checkpoint``); "block_save_coll" does
  too, but keeps the outputs of the collectives that pin tensor-parallel
  contraction outputs (``shard_ctx.tp_out``, the JAX package's
  ``"tp_out"``), so the recompute does not replay them (selective
  checkpointing); with no collectives it equals "block".  The encoder's
  layers are recomputed only under "block", as in the JAX package.

Each layer's parameters pass through ``shard_ctx.gathered`` inside the
remat boundary (the sharded train step's FSDP gather; the identity
elsewhere).
* ``prefill`` — full-sequence forward building decode caches.
* ``decode``  — single-token step consuming/updating caches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..obs import REGISTRY
from . import blocks as B
from . import layers as L
from .config import ATTN, LOCAL_ATTN, RGLRU, RWKV, ModelConfig
from .shard_ctx import (constrain, gathered, local_rows, merge_heads,
                        partial_over, rows_like, tp_out)

BLOCK_TYPES = (ATTN, LOCAL_ATTN, RGLRU, RWKV)
REMAT_BLOCK = ("block", "block_save_coll")
_KV_BYTES = REGISTRY.gauge(
    "repro_kv_cache_bytes", "bytes of the attention K/V rings of the last "
    "decode caches made, by kind: window (L layers) or full (A layers)",
    labels=("kind",))
# the family holds its children weakly
_KV_GAUGES = {k: _KV_BYTES.labels(kind=k) for k in ("window", "full")}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a block type the port has no
    block for."""
    other = sorted(set(cfg.layer_types()) - set(BLOCK_TYPES))
    if other:
        raise NotImplementedError(
            f"{cfg.name}: the port runs block types {BLOCK_TYPES}; this "
            f"config has unknown block types {other}")


# =============================================================================
# Parameter construction
# =============================================================================

def _init_layer(ltype: str, cfg: ModelConfig, gen: torch.Generator) -> dict:
    if ltype in (ATTN, LOCAL_ATTN):
        p = {"attn": B.init_attn(cfg, gen)}
        if cfg.cross_attention:
            p["cross"] = B.init_attn(cfg, gen)
        p["mlp"] = B.init_moe(cfg, gen) if cfg.moe else B.init_mlp(cfg, gen)
        return p
    if ltype == RGLRU:
        return {"rglru": B.init_rglru(cfg, gen), "mlp": B.init_mlp(cfg, gen)}
    if ltype == RWKV:
        return {"rwkv": B.init_rwkv(cfg, gen)}
    raise NotImplementedError(ltype)


def init_params(cfg: ModelConfig, gen: torch.Generator,
                place=None) -> dict:
    """Random parameters from ``gen``, on ``gen``'s device.  ``place``
    (path, subtree) -> subtree, if given, is applied to each top-level
    leaf and each layer as soon as it is made (the trainer slices them
    to a rank's shards there, so the whole tree never exists at once);
    it draws nothing from ``gen``, so the values are the same."""
    check_supported(cfg)
    if place is None:
        def place(path, sub):
            return sub
    dev, V, D = gen.device, cfg.padded_vocab, cfg.d_model
    params: dict = {
        "embed": place(("embed",), torch.randn(
            (V, D), generator=gen, device=dev,
            dtype=torch.float32).mul_(D ** -0.5)),
        "final_norm": place(("final_norm",), torch.zeros(
            (D,), dtype=torch.float32, device=dev)),
    }
    if not cfg.tie_embeddings:
        params["head"] = place(("head",), torch.randn(
            (D, V), generator=gen, device=dev,
            dtype=torch.float32).mul_(D ** -0.5))
    params["layers"] = [place(("layers", i), _init_layer(lt, cfg, gen))
                        for i, lt in enumerate(cfg.layer_types())]
    if cfg.is_encdec:
        # the encoder: the decoder's dims, non-causal, SwiGLU MLPs
        params["encoder"] = {
            "layers": [place(("encoder", "layers", i),
                             {"attn": B.init_attn(cfg, gen),
                              "mlp": B.init_mlp(cfg, gen)})
                       for i in range(cfg.encoder_layers)],
            "final_norm": place(("encoder", "final_norm"), torch.zeros(
                (D,), dtype=torch.float32, device=dev)),
        }
    if cfg.frontend == "vision":
        # stub projection from precomputed patch embeddings to d_model
        params["img_proj"] = place(("img_proj",), torch.randn(
            (D, D), generator=gen, device=dev,
            dtype=torch.float32).mul_(D ** -0.5))
    return params


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: :func:`init_params`
    makes its tensors there, shapes and dtypes without storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree on the ``meta`` device — no allocation (the
    counterpart of the JAX package's ``jax.eval_shape`` of the init)."""
    return init_params(cfg, _MetaGenerator())


# =============================================================================
# Forward
# =============================================================================

def _apply_layer(ltype: str, p: dict, x: torch.Tensor, ctx: B.Ctx,
                 cfg: ModelConfig):
    if ltype in (ATTN, LOCAL_ATTN):
        window = cfg.window if ltype == LOCAL_ATTN else 0
        x, cache = B.apply_attn(p["attn"], x, ctx, cfg, window=window)
        if cfg.cross_attention:
            x = B.apply_cross_attn(p["cross"], x, ctx, cfg)
        if cfg.moe:
            return B.apply_moe(p["mlp"], x, cfg), cache
        return B.apply_mlp(p["mlp"], x, cfg), cache
    if ltype == RGLRU:
        x, cache = B.apply_rglru(p["rglru"], x, ctx, cfg)
        return B.apply_mlp(p["mlp"], x, cfg), cache
    if ltype == RWKV:
        return B.apply_rwkv(p["rwkv"], x, ctx, cfg)
    raise NotImplementedError(ltype)


def _cache_for(ltype: str, cfg: ModelConfig, batch: int, s_max: int,
               device: torch.device):
    if ltype == ATTN:
        return B.init_attn_cache(cfg, batch, s_max, device)
    if ltype == LOCAL_ATTN:
        return B.init_attn_cache(cfg, batch, s_max, device,
                                 window=cfg.window)
    if ltype == RGLRU:
        return B.init_rglru_cache(cfg, batch, device)
    if ltype == RWKV:
        return B.init_rwkv_cache(cfg, batch, device)
    raise NotImplementedError(ltype)


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: torch.device) -> list:
    """Decode caches, one per layer; ``s_max`` sizes the attention
    rings (sliding-window layers hold at most ``cfg.window`` slots).
    Sets ``repro_kv_cache_bytes{kind}`` to the rings' bytes."""
    check_supported(cfg)
    caches = [_cache_for(lt, cfg, batch, s_max, device)
              for lt in cfg.layer_types()]
    kv = {"window": 0, "full": 0}
    for lt, c in zip(cfg.layer_types(), caches):
        if lt in (ATTN, LOCAL_ATTN):
            kv["window" if lt == LOCAL_ATTN else "full"] += \
                c.k.nbytes + c.v.nbytes
    for kind, n in kv.items():
        _KV_GAUGES[kind].set(n)
    return caches


def _gathered_layer(ltype: str, p: dict, x, ctx: B.Ctx, cfg: ModelConfig):
    return _apply_layer(ltype, gathered(p), x, ctx, cfg)


def _is_tp_collective(func) -> bool:
    """An all-reduce of the functional collectives: the op that pins a
    ``tp_out`` (a partial sum over the model axis) inside a layer."""
    return getattr(func, "_overloadpacket", None) is getattr(
        torch.ops._c10d_functional, "all_reduce", ())


def _save_tp_out(ctx, func, *args, **kwargs):
    if _is_tp_collective(func):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_coll_contexts():
    return create_selective_checkpoint_contexts(_save_tp_out)


def _run_layers(params, x, ctx: B.Ctx, cfg: ModelConfig, caches=None):
    """Every layer in order. Returns (x, new_caches or None)."""
    new_caches = []
    remat = ctx.mode == "train" and cfg.remat in REMAT_BLOCK
    kw = {"context_fn": _save_coll_contexts} \
        if cfg.remat == "block_save_coll" else {}
    for i, (lt, lp) in enumerate(zip(cfg.layer_types(), params["layers"])):
        sub_ctx = B.Ctx(ctx.positions, ctx.mode,
                        None if caches is None else caches[i],
                        ctx.enc_out, ctx.enc_pos)
        if remat:
            x, c = checkpoint(_gathered_layer, lt, lp, x, sub_ctx, cfg,
                              use_reentrant=False, **kw)
        else:
            x, c = _gathered_layer(lt, lp, x, sub_ctx, cfg)
        new_caches.append(c)
    return x, (None if all(c is None for c in new_caches) else new_caches)


def _encode(params, frames: torch.Tensor, cfg: ModelConfig,
            mode: str = "train") -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings: non-causal
    self-attention (naive) and a SwiGLU MLP a layer, then the encoder's
    final norm.  In train mode with ``cfg.remat == "block"`` each layer
    is recomputed in the backward."""
    x = frames.to(B.compute_dtype(cfg))
    pos = torch.arange(x.shape[1], dtype=torch.int32,
                       device=x.device).expand(x.shape[:2])
    kv_map = B.head_kv_map(cfg) if cfg.phys_heads != cfg.n_heads else None
    hm = B.head_mask(cfg, x.dtype, x.device)

    def body(x, lp):
        lp = gathered(lp)
        h = L.rms_norm(x, B._c(lp["attn"]["ln"], cfg), cfg.norm_eps)
        q, k, v = B._qkv(lp["attn"], h, cfg)
        out = L.attention(q, k, v, pos, pos, causal=False, impl="naive",
                          kv_map=kv_map)
        if hm is not None:
            out = out * hm[None, None, :, None]
        x = x + tp_out(merge_heads(out) @ B._c(lp["attn"]["wo"], cfg))
        return B.apply_mlp(lp["mlp"], x, cfg)

    remat = mode == "train" and cfg.remat == "block"
    for lp in params["encoder"]["layers"]:
        x = checkpoint(body, x, lp, use_reentrant=False) if remat \
            else body(x, lp)
    return L.rms_norm(x, gathered(params["encoder"]["final_norm"]
                                  ).to(x.dtype), cfg.norm_eps)


def _lookup(tokens, table):
    """``F.embedding``.  A table sharded over its vocab rows (a DTensor,
    ``Shard(0)`` on the model axis) is looked up as a vocab-parallel
    embedding: each rank its own rows (others masked to 0), a partial
    sum over the shards that the caller's ``constrain`` all-reduces;
    the gradient comes back whole to every shard."""
    from torch.distributed.tensor import DTensor, Partial
    if not isinstance(table, DTensor) or not isinstance(tokens, DTensor):
        return F.embedding(tokens, table)
    dims = [d for d, p in enumerate(table.placements) if p.is_shard(0)]
    if not dims:
        return F.embedding(tokens, table)
    (md,) = dims
    mesh = table.device_mesh
    # the table's gradient from this rank's sequences is partial along
    # the axes the tokens are sharded on
    w = table.to_local(grad_placements=[
        Partial() if t.is_shard() and p.is_replicate() else p
        for p, t in zip(table.placements, tokens.placements)])
    v0 = mesh.get_local_rank(md) * w.shape[0]
    ids = tokens.to_local().long() - v0
    ok = (ids >= 0) & (ids < w.shape[0])
    out = F.embedding(ids.clamp(0, w.shape[0] - 1), w) * \
        ok[..., None].to(w.dtype)
    return partial_over(out, tokens, md)


def _embed_inputs(params, batch: dict, cfg: ModelConfig, mode: str):
    """Token embedding and modality prefixes.  Returns (x, positions,
    enc_out, enc_pos, offset): ``offset`` image-prefix rows lead x, and
    given decode positions move past them."""
    tokens = batch["tokens"]
    dt = B.compute_dtype(cfg)
    # the residual stream starts batch-sharded and replicated over model
    x = constrain(_lookup(tokens, gathered(params["embed"])),
                  "batch", None, None).to(dt)
    x = x * (cfg.d_model ** 0.5)
    offset = 0
    enc_out = enc_pos = None
    if cfg.frontend == "vision" and "img_embeds" in batch:
        img = batch["img_embeds"].to(dt) @ gathered(params["img_proj"]).to(dt)
        x = torch.cat([img, x], dim=1)
        offset = img.shape[1]
    if cfg.is_encdec and "frames" in batch:
        enc_out = _encode(params, batch["frames"], cfg, mode)
    elif cfg.is_encdec and "enc_out" in batch:
        enc_out = batch["enc_out"].to(dt)     # decode: the encoder ran once
    if enc_out is not None:
        enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                               device=x.device).expand(enc_out.shape[:2])
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device).expand(x.shape[:2])
    elif offset:
        prefix = torch.arange(offset, dtype=positions.dtype,
                              device=x.device).expand(x.shape[0], offset)
        positions = torch.cat([prefix, positions + offset], dim=1)
    return x, positions, enc_out, enc_pos, offset


def forward(params, batch: dict, cfg: ModelConfig, mode: str = "train",
            caches=None):
    """Returns (final hidden states of the token positions, new_caches)."""
    x, positions, enc_out, enc_pos, offset = _embed_inputs(params, batch,
                                                           cfg, mode)
    ctx = B.Ctx(positions, mode, None, enc_out, enc_pos)
    x, new_caches = _run_layers(params, x, ctx, cfg, caches)
    x = L.rms_norm(x, gathered(params["final_norm"]).to(x.dtype),
                   cfg.norm_eps)
    if offset:  # drop the modality prefix before the LM head
        x = x[:, offset:]
    return x, new_caches


def _head_matrix(params, cfg):
    return gathered(params["embed"]).T if cfg.tie_embeddings \
        else gathered(params["head"])


def logits_from_hidden(params, x, cfg):
    """float32 logits: the head cast to x's dtype, multiplied as f32
    values with f32 accumulation (so a bf16 model's product is not
    rounded to bf16)."""
    w = _head_matrix(params, cfg).to(x.dtype)
    out = x.to(torch.float32) @ w.to(torch.float32)
    if cfg.logit_softcap:
        out = torch.tanh(out / cfg.logit_softcap) * cfg.logit_softcap
    if cfg.padded_vocab != cfg.vocab:   # mask vocab-padding columns
        out[..., cfg.vocab:] -= 1e9
    return out


def loss_fn(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy (labels = batch['labels'])."""
    x, _ = forward(params, batch, cfg, mode="train")
    labels = batch["labels"]
    if cfg.loss_chunk:
        w = _head_matrix(params, cfg).to(x.dtype)
        return L.chunked_cross_entropy(x, w, labels, cfg.loss_chunk,
                                       valid_vocab=cfg.vocab)
    return L.cross_entropy(logits_from_hidden(params, x, cfg), labels)


def prefill(params, batch: dict, cfg: ModelConfig, s_max: int):
    """Run the prompt, build decode caches. Returns (last_logits, caches)."""
    tokens = batch["tokens"]
    # sharded: each rank makes the rings of its own sequences
    rows = local_rows(tokens)
    caches = [type(c)(*[rows_like(f, tokens) if isinstance(f, torch.Tensor)
                        else f for f in c])
              for c in init_cache(cfg, rows.shape[0], s_max, rows.device)]
    x, new_caches = forward(params, batch, cfg, mode="prefill",
                            caches=caches)
    return logits_from_hidden(params, x[:, -1:], cfg), new_caches


def decode_step(params, caches, batch: dict, cfg: ModelConfig):
    """One decode step: batch['tokens'] is (B, 1); returns (logits, caches)."""
    x, new_caches = forward(params, batch, cfg, mode="decode",
                            caches=caches)
    return logits_from_hidden(params, x, cfg), new_caches
