"""Model assembly: init, forward, prefill/decode — the JAX package's
``models/model.py`` on PyTorch, for the block types the port has:
global and sliding-window attention with a SwiGLU MLP (``A``, ``L``),
RG-LRU with a SwiGLU MLP (``R``) and RWKV-6 (``W``).  MoE,
encoder–decoder and vision prefixes raise ``NotImplementedError``.

Parameters are a dict: ``embed`` (V, D), ``final_norm`` (D,), ``head``
(D, V) unless tied, and ``layers``, one dict per layer (``{"attn": ...,
"mlp": ...}``, ``{"rglru": ..., "mlp": ...}`` or ``{"rwkv": ...}``) —
the JAX package's layer groups stacked for ``lax.scan`` become a list
walked by a Python loop.  Decode caches are a list with one entry per
layer, likewise.

Modes:
* ``train``   — full-sequence forward.
* ``prefill`` — full-sequence forward building decode caches.
* ``decode``  — single-token step consuming/updating caches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import blocks as B
from . import layers as L
from .config import ATTN, LOCAL_ATTN, RGLRU, RWKV, ModelConfig

BLOCK_TYPES = (ATTN, LOCAL_ATTN, RGLRU, RWKV)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port has no blocks for."""
    other = sorted(set(cfg.layer_types()) - set(BLOCK_TYPES))
    if other or cfg.moe is not None or cfg.is_encdec or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the port runs block types {BLOCK_TYPES} with a "
            f"dense MLP and a text-only decoder; this config has unknown "
            f"block types {other}, moe={cfg.moe is not None}, encoder "
            f"layers {cfg.encoder_layers}, frontend {cfg.frontend!r}")


# =============================================================================
# Parameter construction
# =============================================================================

def _init_layer(ltype: str, cfg: ModelConfig, gen: torch.Generator) -> dict:
    if ltype in (ATTN, LOCAL_ATTN):
        return {"attn": B.init_attn(cfg, gen), "mlp": B.init_mlp(cfg, gen)}
    if ltype == RGLRU:
        return {"rglru": B.init_rglru(cfg, gen), "mlp": B.init_mlp(cfg, gen)}
    if ltype == RWKV:
        return {"rwkv": B.init_rwkv(cfg, gen)}
    raise NotImplementedError(ltype)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters from ``gen``, on ``gen``'s device."""
    check_supported(cfg)
    dev, V, D = gen.device, cfg.padded_vocab, cfg.d_model
    params: dict = {
        "embed": torch.randn((V, D), generator=gen, device=dev,
                             dtype=torch.float32).mul_(D ** -0.5),
        "final_norm": torch.zeros((D,), dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = torch.randn((D, V), generator=gen, device=dev,
                                     dtype=torch.float32).mul_(D ** -0.5)
    params["layers"] = [_init_layer(lt, cfg, gen) for lt in cfg.layer_types()]
    return params


# =============================================================================
# Forward
# =============================================================================

def _apply_layer(ltype: str, p: dict, x: torch.Tensor, ctx: B.Ctx,
                 cfg: ModelConfig):
    if ltype in (ATTN, LOCAL_ATTN):
        window = cfg.window if ltype == LOCAL_ATTN else 0
        x, cache = B.apply_attn(p["attn"], x, ctx, cfg, window=window)
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
    rings (sliding-window layers hold at most ``cfg.window`` slots)."""
    check_supported(cfg)
    return [_cache_for(lt, cfg, batch, s_max, device)
            for lt in cfg.layer_types()]


def _run_layers(params, x, ctx: B.Ctx, cfg: ModelConfig, caches=None):
    """Every layer in order. Returns (x, new_caches or None)."""
    new_caches = []
    for i, (lt, lp) in enumerate(zip(cfg.layer_types(), params["layers"])):
        sub_ctx = B.Ctx(ctx.positions, ctx.mode,
                        None if caches is None else caches[i])
        x, c = _apply_layer(lt, lp, x, sub_ctx, cfg)
        new_caches.append(c)
    return x, (None if all(c is None for c in new_caches) else new_caches)


def _embed_inputs(params, batch: dict, cfg: ModelConfig):
    """Token embedding and positions. Returns (x, positions)."""
    tokens = batch["tokens"]
    x = F.embedding(tokens, params["embed"]).to(B.compute_dtype(cfg))
    x = x * (cfg.d_model ** 0.5)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device).expand(x.shape[:2])
    return x, positions


def forward(params, batch: dict, cfg: ModelConfig, mode: str = "train",
            caches=None):
    """Returns (final hidden states, new_caches)."""
    x, positions = _embed_inputs(params, batch, cfg)
    ctx = B.Ctx(positions, mode)
    x, new_caches = _run_layers(params, x, ctx, cfg, caches)
    x = L.rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return x, new_caches


def _head_matrix(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


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


def prefill(params, batch: dict, cfg: ModelConfig, s_max: int):
    """Run the prompt, build decode caches. Returns (last_logits, caches)."""
    tokens = batch["tokens"]
    caches = init_cache(cfg, tokens.shape[0], s_max, tokens.device)
    x, new_caches = forward(params, batch, cfg, mode="prefill",
                            caches=caches)
    return logits_from_hidden(params, x[:, -1:], cfg), new_caches


def decode_step(params, caches, batch: dict, cfg: ModelConfig):
    """One decode step: batch['tokens'] is (B, 1); returns (logits, caches)."""
    x, new_caches = forward(params, batch, cfg, mode="decode",
                            caches=caches)
    return logits_from_hidden(params, x, cfg), new_caches
