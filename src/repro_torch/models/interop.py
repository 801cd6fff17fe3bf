"""Carry model parameters into the port: the JAX package's, so both
packages can compute on the same weights, and a published checkpoint's
(:func:`params_from_published`)."""
from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from ..tree import tree_map
from .config import ATTN, LOCAL_ATTN, ModelConfig
from .model import check_supported


def params_from_jax(cfg: ModelConfig, np_params: dict,
                    device: "str | torch.device | None" = None) -> dict:
    """The port's parameters (see :mod:`repro_torch.models.model`) from
    the JAX package's parameter tree given as numpy arrays: ``embed``,
    ``final_norm``, ``head``, ``img_proj``, ``groups/slot<i>/...``
    stacked with a leading axis of layer groups, ``tail/layer<j>``, and
    ``encoder/layers`` stacked with a leading axis of encoder layers
    beside ``encoder/final_norm``.  Each layer's blocks (``attn``,
    ``cross``, ``mlp`` with its MoE router and (E, ·, ·) expert
    tensors, ...) are carried as they are.  The arrays are copied onto
    ``device`` (default :func:`get_device`)."""
    check_supported(cfg)
    dev = get_device() if device is None else torch.device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a), device=dev)

    out = {k: tensor(np_params[k])
           for k in ("embed", "final_norm", "head", "img_proj")
           if k in np_params}
    period = len(cfg.pattern)
    n_grouped = cfg.n_layers // period * period
    layers = []
    for li in range(cfg.n_layers):
        if li < n_grouped:
            group, slot = divmod(li, period)
            layer = tree_map(lambda a, g=group: np.asarray(a)[g],
                             np_params["groups"][f"slot{slot}"])
        else:
            layer = np_params["tail"][f"layer{li - n_grouped}"]
        layers.append(tree_map(tensor, layer))
    out["layers"] = layers
    if "encoder" in np_params:
        enc = np_params["encoder"]
        out["encoder"] = {
            "layers": [tree_map(lambda a, i=i: tensor(np.asarray(a)[i]),
                                enc["layers"])
                       for i in range(cfg.encoder_layers)],
            "final_norm": tensor(enc["final_norm"])}
    return out


def params_from_published(cfg: ModelConfig, tensors,
                          dtype: "torch.dtype | None" = None) -> dict:
    """The port's parameters from a checkpoint in the Hugging Face
    layout of a Llama-style decoder with sparse experts (Qwen3-MoE's
    names, one tensor an expert): ``model.embed_tokens.weight`` (V, D);
    for layer i, ``model.layers.<i>.`` + ``input_layernorm.weight``,
    ``self_attn.{q,k,v,o}_proj.weight`` (out, in),
    ``post_attention_layernorm.weight``, ``mlp.gate.weight`` (E, D) and
    ``mlp.experts.<e>.{gate,up,down}_proj.weight`` (out, in);
    ``model.norm.weight``; ``lm_head.weight`` (V, D).

    ``tensors`` maps a name to its tensor and may make each when it is
    read; each is read once, on its own device, and the layer it
    belongs to is made, in ``dtype`` (default ``cfg.serve_param_dtype``),
    before the next is read, so the checkpoint never exists whole beside
    the parameters.  The conventions change: a weight (out, in) becomes
    the port's (in, out); an RMSNorm weight w is stored as w - 1 (the
    port applies 1 + scale: exact for w in [0.5, 2]); the embedding is
    divided by sqrt(d_model), which the port multiplies it by again (one
    rounding in ``dtype`` each way)."""
    check_supported(cfg)
    if cfg.moe is None or set(cfg.layer_types()) - {ATTN, LOCAL_ATTN} or \
            cfg.qkv_bias or cfg.tie_embeddings or cfg.is_encdec or \
            cfg.frontend or cfg.padded_vocab != cfg.vocab:
        raise NotImplementedError(
            f"{cfg.name}: the published layout is read for untied "
            f"attention-and-experts decoders only")
    dt = dtype or getattr(torch, cfg.serve_param_dtype)

    def read(name, conv=None):
        t = tensors[name].to(torch.float32)
        return (conv(t) if conv is not None else t).contiguous().to(dt)

    def norm(w):
        return w - 1.0

    def experts(pre, proj):
        return torch.stack([read(f"{pre}mlp.experts.{e}.{proj}.weight",
                                 torch.t)
                            for e in range(cfg.moe.n_experts)])

    out = {"embed": read("model.embed_tokens.weight",
                         lambda w: w / cfg.d_model ** 0.5),
           "final_norm": read("model.norm.weight", norm),
           "head": read("lm_head.weight", torch.t), "layers": []}
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        attn = {"ln": read(pre + "input_layernorm.weight", norm)}
        for p in "qkvo":
            attn[f"w{p}"] = read(f"{pre}self_attn.{p}_proj.weight", torch.t)
        out["layers"].append({"attn": attn, "mlp": {
            "ln": read(pre + "post_attention_layernorm.weight", norm),
            "router": read(pre + "mlp.gate.weight", torch.t),
            "w_gate": experts(pre, "gate_proj"),
            "w_up": experts(pre, "up_proj"),
            "w_down": experts(pre, "down_proj")}})
    return out
