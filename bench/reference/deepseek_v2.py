"""DeepSeek-V2-Lite's forward pass in plain float32 ``torch``.

The published config.json (hf:deepseek-ai/DeepSeek-V2-Lite) gives every
number, read from a dict with its keys (``hidden_size``,
``num_attention_heads``, ``kv_lora_rank``, ``q_lora_rank``,
``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``,
``first_k_dense_replace``, ``n_routed_experts``, ``n_shared_experts``,
``num_experts_per_tok``, ``moe_intermediate_size``,
``intermediate_size``, ``norm_topk_prob``, ``routed_scaling_factor``,
``rope_theta``, ``rope_scaling``, ``rms_norm_eps``, ``vocab_size``,
``num_hidden_layers``).  The decompressed form of Hugging Face's
``modeling_deepseek.py`` (``DeepseekV2Attention``, ``DeepseekV2MoE``)
and the DeepSeek-V2 paper, section 2.1; each layer:

* pre-norm multi-head latent attention with no q-LoRA:
  q = h·W_q, each head [q_nope (dn) | q_pe (dr)];
  [c | k_pe] = h·W_kva, c = RMSNorm(c) (``kv_a_layernorm``);
  [k_nope | v] = c·W_kvb a head; k = [k_nope | k_pe], k_pe shared by
  every head; the rope dims of q_pe and k_pe, stored interleaved as
  (pair, 2), de-interleaved (even, then odd) and rotated by halves, as
  ``apply_rotary_pos_emb`` does; causal attention with the scores
  scaled by (dn + dr)^-0.5 · m², m = 0.1·mscale_all_dim·ln(factor) + 1;
* DeepSeek's YaRN (``DeepseekV2YarnRotaryEmbedding``): each frequency
  blended between itself and itself / factor over a linear ramp from
  the ``beta_fast`` to the ``beta_slow`` rotation's dimension of the
  original context, cos and sin times m(mscale) / m(mscale_all_dim);
* a pre-norm MLP: the first ``first_k_dense_replace`` layers a SwiGLU
  of width ``intermediate_size``; the others a softmax router over the
  routed experts (``topk_method`` greedy), the top-k probabilities
  renormalized only where ``norm_topk_prob`` (else times
  ``routed_scaling_factor``), each expert a SwiGLU of width
  ``moe_intermediate_size``, plus the shared experts, one SwiGLU of
  width ``n_shared_experts · moe_intermediate_size`` that every token
  takes; no expert drops a token.

Departures from the published model:

* no q-LoRA (``q_lora_rank`` null in the published config; the
  reference raises for another value);
* the router's auxiliary loss (``seq_aux``, ``aux_loss_alpha``) is a
  training term and is not computed;
* ``n_group`` and ``topk_group`` (1 and 1) select among one group: the
  plain greedy top-k.

Parameters: a mapping from the checkpoint's names to tensors of any
float type on any device, in the Hugging Face layout: weights
(out, in); ``model.embed_tokens.weight`` (V, D) read as it is; for
layer i, ``model.layers.<i>.`` + ``input_layernorm.weight``,
``self_attn.{q_proj,kv_a_proj_with_mqa,kv_b_proj,o_proj}.weight``,
``self_attn.kv_a_layernorm.weight``, ``post_attention_layernorm.weight``
and ``mlp.{gate,up,down}_proj.weight`` (dense layers) or
``mlp.gate.weight`` (E, D), ``mlp.experts.<e>.{gate,up,down}_proj.weight``
and ``mlp.shared_experts.{gate,up,down}_proj.weight``;
``model.norm.weight``; ``lm_head.weight`` (V, D).  An RMSNorm multiplies
by its weight.

One layer at a time: a layer's weights are read once, upcast to float32
on the tokens' device, and run over every sequence in turn (each on its
own: nothing is batched).  Attention runs in blocks of queries, each
over the keys it can see, so a 32k-token sequence fits beside the
program's weights.  ``round_to`` (the control): every product's inputs
rounded to that type with one scale a tensor, as in
``bench/reference/mellum2.py``.
"""
import math

import torch

from bench.reference.mellum2 import _Products, _rms, _rotate

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32


def _yarn_m(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn(config: dict, device=None):
    """(dr // 2,) inverse frequencies over the rope dims, the cos/sin
    factor and the softmax's factor m², as DeepSeek's YaRN has them."""
    dim = int(config["qk_rope_head_dim"])
    base = float(config["rope_theta"])
    rs = config.get("rope_scaling")
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=F32, device=device)
                           / dim)
    if not rs:
        return extra, 1.0, 1.0
    factor = float(rs["factor"])
    orig = float(rs["original_max_position_embeddings"])

    def dim_of(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / \
            (2 * math.log(base))

    low = max(math.floor(dim_of(float(rs.get("beta_fast", 32)))), 0)
    high = min(math.ceil(dim_of(float(rs.get("beta_slow", 1)))), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=F32, device=device)
                        - low) / (high - low), 0, 1)
    mask = 1.0 - ramp                   # 1: the frequency kept as it is
    inv = extra / factor * (1 - mask) + extra * mask
    ms, ms_all = float(rs.get("mscale", 1)), float(rs.get("mscale_all_dim",
                                                          0))
    cos_sin = _yarn_m(factor, ms) / _yarn_m(factor, ms_all)
    softmax = _yarn_m(factor, ms_all) ** 2 if ms_all else 1.0
    return inv, cos_sin, softmax


def _deinterleave(x):
    """The last dim stored as (pair, 2) → even entries, then odd."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def _attention(q, k, v, scale, mm, q_block):
    """q, k (S, H, dq), v (S, H, dv); causal.  Returns (S, H·dv)."""
    S, H, _ = q.shape
    dv = v.shape[-1]
    qh, kt, vh = q.permute(1, 0, 2), k.permute(1, 2, 0), v.permute(1, 0, 2)
    out = torch.empty((S, H, dv), dtype=F32, device=q.device)
    for i0 in range(0, S, q_block):
        i1 = min(S, i0 + q_block)
        s = mm(qh[:, i0:i1], kt[:, :, :i1]) * scale           # (H, bq, i1)
        i = torch.arange(i0, i1, device=q.device)[:, None]
        j = torch.arange(0, i1, device=q.device)[None, :]
        p = torch.softmax(s.masked_fill(j > i, -math.inf), dim=-1)
        out[i0:i1] = mm(p, vh[:, :i1]).permute(1, 0, 2)
    return out.reshape(S, H * dv)


def _swiglu(x, lw, pre, mm):
    a = torch.nn.functional.silu(mm.linear(x, lw[pre + "gate_proj.weight"]))
    return mm.linear(a * mm.linear(x, lw[pre + "up_proj.weight"]),
                     lw[pre + "down_proj.weight"])


def _moe(h, lw, config, mm):
    """The sparse MLP over h (S, D): every token's top-k routed experts
    and the shared experts."""
    k = int(config["num_experts_per_tok"])
    probs = torch.softmax(mm.linear(h, lw["mlp.gate.weight"]), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    if k > 1 and config.get("norm_topk_prob"):
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-20)
    else:
        gate = gate * float(config.get("routed_scaling_factor", 1.0))
    out = torch.zeros_like(h)
    for e in range(int(config["n_routed_experts"])):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            out.index_add_(0, tok, _swiglu(h[tok], lw, f"mlp.experts.{e}.",
                                           mm) * gate[tok, slot, None])
    if int(config.get("n_shared_experts") or 0):
        out = out + _swiglu(h, lw, "mlp.shared_experts.", mm)
    return out


def layer_names(config: dict, i: int) -> list:
    """The checkpoint's names of layer ``i``'s tensors."""
    pre = f"model.layers.{i}."
    names = ["input_layernorm.weight", "post_attention_layernorm.weight",
             "self_attn.kv_a_layernorm.weight"]
    names += [f"self_attn.{p}.weight" for p in (
        "q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj")]
    mlps = ["mlp."]
    if i >= int(config["first_k_dense_replace"]):
        names.append("mlp.gate.weight")
        mlps = [f"mlp.experts.{e}."
                for e in range(int(config["n_routed_experts"]))]
        if int(config.get("n_shared_experts") or 0):
            mlps.append("mlp.shared_experts.")
    names += [m + f"{p}_proj.weight" for m in mlps
              for p in ("gate", "up", "down")]
    return [pre + n for n in names]


def forward(params, tokens, config: dict, last: int = 0, round_to=None,
            q_block: int = 512) -> list:
    """float32 logits (the ``last`` or all positions, ``vocab_size``
    columns) of each sequence in ``tokens``, a list of (S,) id tensors on
    one device, in the list's order."""
    if config.get("q_lora_rank"):
        raise NotImplementedError("q-LoRA is not built")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = _Products(round_to)
    dev = tokens[0].device
    H = int(config["num_attention_heads"])
    R, dn = int(config["kv_lora_rank"]), int(config["qk_nope_head_dim"])
    dr, dv = int(config["qk_rope_head_dim"]), int(config["v_head_dim"])
    eps = float(config["rms_norm_eps"])
    inv, cos_sin, m2 = yarn(config, dev)
    scale = (dn + dr) ** -0.5 * m2

    def read(name):
        return params[name].to(device=dev, dtype=F32)

    embed = params["model.embed_tokens.weight"]
    xs = [embed[t.to(embed.device).long()].to(device=dev, dtype=F32)
          for t in tokens]
    del embed
    for i in range(int(config["num_hidden_layers"])):
        pre = f"model.layers.{i}."
        lw = {n[len(pre):]: read(n) for n in layer_names(config, i)}
        dense = i < int(config["first_k_dense_replace"])
        for r, x in enumerate(xs):
            S = x.shape[0]
            ang = torch.arange(S, dtype=F32, device=dev)[:, None] * inv
            cos, sin = torch.cos(ang) * cos_sin, torch.sin(ang) * cos_sin
            h = _rms(x, lw["input_layernorm.weight"], eps)
            q = mm.linear(h, lw["self_attn.q_proj.weight"]).reshape(
                S, H, dn + dr)
            ckv = mm.linear(h, lw["self_attn.kv_a_proj_with_mqa.weight"])
            c = _rms(ckv[:, :R], lw["self_attn.kv_a_layernorm.weight"], eps)
            kv = mm.linear(c, lw["self_attn.kv_b_proj.weight"]).reshape(
                S, H, dn + dv)
            q_pe = _rotate(_deinterleave(q[..., dn:]), cos, sin)
            k_pe = _rotate(_deinterleave(ckv[:, None, R:]), cos, sin)
            o = _attention(torch.cat([q[..., :dn], q_pe], dim=-1),
                           torch.cat([kv[..., :dn],
                                      k_pe.expand(S, H, dr)], dim=-1),
                           kv[..., dn:], scale, mm, q_block)
            x = x + mm.linear(o, lw["self_attn.o_proj.weight"])
            h = _rms(x, lw["post_attention_layernorm.weight"], eps)
            xs[r] = x + (_swiglu(h, lw, "mlp.", mm) if dense
                         else _moe(h, lw, config, mm))
            del x, h, q, ckv, c, kv, o
        del lw
    norm, head = read("model.norm.weight"), read("lm_head.weight")
    V = int(config["vocab_size"])
    return [mm.linear(_rms(x[-last:] if last else x, norm, eps),
                      head)[:, :V] for x in xs]
