"""Mellum2-12B-A2.5B's forward pass in plain float32 ``torch``.

The published config.json (hf:JetBrains/Mellum2-12B-A2.5B-Instruct)
gives every number, read from a dict with its keys (``hidden_size``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim``,
``layer_types``, ``sliding_window``, ``rope_parameters``,
``num_experts``, ``num_experts_per_tok``, ``moe_intermediate_size``,
``rms_norm_eps``, ``vocab_size``).  Each layer: pre-norm GQA attention
(causal; ``sliding_attention`` layers see the last ``sliding_window``
positions, ``full_attention`` layers all), the rope of the layer's kind
(``default``, or ``yarn`` with its ramp and ``attention_factor``), then
a pre-norm sparse MLP: a softmax router, the top-k experts, their gates
renormalized (``norm_topk_prob``), each expert a SwiGLU; no expert
drops a token.

Departures from the published model:

* no MTP head: the config has no key for one, and next-token serving
  does not run it;
* the router's scoring function is a softmax (the config names none:
  assumed);
* no q/k norm (the config names none: assumed).

Parameters: a mapping from the checkpoint's names to tensors of any
float type on any device, in the Hugging Face layout and conventions of
a Llama-style decoder with sparse experts (Qwen3-MoE's names, one
tensor an expert): ``model.embed_tokens.weight`` (V, D), read as it is;
for layer i, ``model.layers.<i>.`` + ``input_layernorm.weight``,
``self_attn.{q,k,v,o}_proj.weight`` (out, in),
``post_attention_layernorm.weight``, ``mlp.gate.weight`` (E, D) and
``mlp.experts.<e>.{gate,up,down}_proj.weight`` (out, in);
``model.norm.weight``; ``lm_head.weight`` (V, D).  An RMSNorm
multiplies by its weight; rope rotates the two halves of a head.

One layer at a time: a layer's weights are read once, upcast to float32
on the tokens' device, and run over every sequence in turn (each on its
own: nothing is batched).  Attention runs in blocks of queries, each
over the keys it can see, so a 16k-token sequence fits beside the
program's weights.  ``round_to`` (the control): every product's inputs
rounded to that type with one scale a tensor (its largest magnitude to
the type's largest finite value), computing below the stated precision.
"""
import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32


def rope_inv_freq(rope: dict, dim: int, device=None):
    """(dim // 2,) inverse frequencies and the cos/sin scale of one
    entry of ``rope_parameters``."""
    theta = float(rope["rope_theta"])
    pos = theta ** (torch.arange(0, dim, 2, dtype=F32, device=device) / dim)
    kind = rope.get("rope_type", "default")
    if kind == "default":
        return 1.0 / pos, 1.0
    if kind != "yarn":
        raise ValueError(f"rope_type {kind!r}")
    factor = float(rope["factor"])
    orig = float(rope["original_max_position_embeddings"])

    def dim_of(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / \
            (2 * math.log(theta))

    low = max(math.floor(dim_of(float(rope.get("beta_fast", 32)))), 0)
    high = min(math.ceil(dim_of(float(rope.get("beta_slow", 1)))), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=F32, device=device)
                        - low) / (high - low), 0, 1)
    extrapolate = 1 - ramp
    inv = (1.0 / (factor * pos)) * (1 - extrapolate) + \
        (1.0 / pos) * extrapolate
    scale = rope.get("attention_factor")
    if scale is None:
        scale = 0.1 * math.log(factor) + 1.0
    return inv, float(scale)


class _Products:
    """Products with a weight (out, in) in float32, or, for the control,
    of inputs rounded to ``round_to`` with one scale a tensor."""

    def __init__(self, round_to=None):
        self.round_to = round_to

    def _round(self, t):
        if self.round_to is None:
            return t
        top = torch.finfo(self.round_to).max
        amax = t.abs().amax().clamp_min(1e-30)
        return (t * (top / amax)).to(self.round_to).to(F32) * (amax / top)

    def __call__(self, a, b):
        return torch.matmul(self._round(a), self._round(b))

    def linear(self, x, w):
        return self(x, w.T)


def _rms(x, weight, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * weight


def _rotate(x, cos, sin):
    """x (S, heads, Dh) by the half-split rotation (cos, sin: (S, Dh/2))."""
    half = x.shape[-1] // 2
    c, s = cos[:, None], sin[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q, k, v, window, mm, q_block):
    """q (S, H, Dh), k, v (S, KV, Dh); causal, and within ``window``
    positions when it is not 0.  Returns (S, H·Dh)."""
    S, H, Dh = q.shape
    KV = k.shape[1]
    g = H // KV
    qg = q.reshape(S, KV, g, Dh).permute(1, 2, 0, 3)        # (KV, g, S, Dh)
    kt = k.permute(1, 2, 0)                                 # (KV, Dh, S)
    vv = v.permute(1, 0, 2)[:, None]                        # (KV, 1, S, Dh)
    out = torch.empty((S, H, Dh), dtype=F32, device=q.device)
    for i0 in range(0, S, q_block):
        i1 = min(S, i0 + q_block)
        j0 = max(0, i0 - window + 1) if window else 0
        s = mm(qg[:, :, i0:i1], kt[:, None, :, j0:i1]) * Dh ** -0.5
        i = torch.arange(i0, i1, device=q.device)[:, None]
        j = torch.arange(j0, i1, device=q.device)[None, :]
        ok = j <= i
        if window:
            ok = ok & (i - j < window)
        p = torch.softmax(s.masked_fill(~ok, -math.inf), dim=-1)
        o = mm(p, vv[..., j0:i1, :])                        # (KV, g, bq, Dh)
        out[i0:i1] = o.permute(2, 0, 1, 3).reshape(i1 - i0, H, Dh)
    return out.reshape(S, H * Dh)


def _moe(h, lw, config, mm):
    """The sparse MLP over h (S, D): every token's top-k experts."""
    k = int(config["num_experts_per_tok"])
    probs = torch.softmax(mm.linear(h, lw["mlp.gate.weight"]), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    if config.get("norm_topk_prob", True):
        gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(int(config["num_experts"])):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        w = f"mlp.experts.{e}."
        a = torch.nn.functional.silu(mm.linear(x, lw[w + "gate_proj.weight"]))
        a = a * mm.linear(x, lw[w + "up_proj.weight"])
        out.index_add_(0, tok, mm.linear(a, lw[w + "down_proj.weight"])
                       * gate[tok, slot, None])
    return out


def layer_names(config: dict, i: int) -> list:
    """The checkpoint's names of layer ``i``'s tensors."""
    pre = f"model.layers.{i}."
    names = ["input_layernorm.weight", "post_attention_layernorm.weight",
             "mlp.gate.weight"]
    names += [f"self_attn.{p}_proj.weight" for p in "qkvo"]
    names += [f"mlp.experts.{e}.{p}_proj.weight"
              for e in range(int(config["num_experts"]))
              for p in ("gate", "up", "down")]
    return [pre + n for n in names]


def forward(params, tokens, config: dict, last: int = 0, round_to=None,
            q_block: int = 512) -> list:
    """float32 logits (the ``last`` or all positions, ``vocab_size``
    columns) of each sequence in ``tokens``, a list of (S,) id tensors on
    one device, in the list's order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = _Products(round_to)
    dev = tokens[0].device
    D, H = int(config["hidden_size"]), int(config["num_attention_heads"])
    KV = int(config["num_key_value_heads"])
    Dh = int(config.get("head_dim") or D // H)
    eps = float(config["rms_norm_eps"])
    window = int(config["sliding_window"])

    def read(name):
        return params[name].to(device=dev, dtype=F32)

    ropes = {}
    for kind, rope in config["rope_parameters"].items():
        inv, scale = rope_inv_freq(rope, Dh, dev)
        ropes[kind] = inv, scale
    embed = params["model.embed_tokens.weight"]
    xs = [embed[t.to(embed.device).long()].to(device=dev, dtype=F32)
          for t in tokens]
    del embed
    for i, kind in enumerate(config["layer_types"]):
        pre = f"model.layers.{i}."
        lw = {n[len(pre):]: read(n) for n in layer_names(config, i)}
        inv, scale = ropes[kind]
        for r, x in enumerate(xs):
            S = x.shape[0]
            ang = torch.arange(S, dtype=F32, device=dev)[:, None] * inv
            cos, sin = torch.cos(ang) * scale, torch.sin(ang) * scale
            h = _rms(x, lw["input_layernorm.weight"], eps)
            q = mm.linear(h, lw["self_attn.q_proj.weight"])
            k = mm.linear(h, lw["self_attn.k_proj.weight"])
            v = mm.linear(h, lw["self_attn.v_proj.weight"]).reshape(S, KV, Dh)
            q = _rotate(q.reshape(S, H, Dh), cos, sin)
            k = _rotate(k.reshape(S, KV, Dh), cos, sin)
            o = _attention(q, k, v,
                           window if kind == "sliding_attention" else 0,
                           mm, q_block)
            x = x + mm.linear(o, lw["self_attn.o_proj.weight"])
            xs[r] = x + _moe(_rms(x, lw["post_attention_layernorm.weight"],
                                  eps), lw, config, mm)
            del x, h, q, k, v, o
        del lw
    norm, head = read("model.norm.weight"), read("lm_head.weight")
    V = int(config["vocab_size"])
    return [mm.linear(_rms(x[-last:] if last else x, norm, eps),
                      head)[:, :V] for x in xs]
