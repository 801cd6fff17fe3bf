"""DeepSeek-V2-Lite's weights drawn from a run's seed, in the published
layout.

``Weights(config, seed, device)`` maps each name of the checkpoint (the
names and conventions ``bench/reference/deepseek_v2.py`` reads) to a
bfloat16 tensor on ``device``, drawn from its own generator, seeded by
the run's seed and the name, each time it is read, as
``bench/traffic/mellum2_weights.py`` draws Mellum2's: the program loads
them once through its own loader, and the reference reads the same
values again after the timed window.  Nothing here imports the program.

The draw, per tensor (D the hidden size, E the routed experts, k a
token's):

* projections: normal, scaled by fan-in to the -1/2, but ``q_proj`` by
  ``Q_GAIN`` times that (a query meets a key with a score of spread
  about 2 under the softmax's m² = 1.59), and the routed experts'
  ``down_proj`` by ``EXPERT_GAIN`` times it, so the sparse MLP writes
  about as much into the residual stream as attention and the shared
  experts do;
* RMSNorm weights (``kv_a_layernorm`` too): uniform in [0.75, 1.25);
* the embedding: normal, except on dimensions 0..E-1 (the router's
  band): each token id has k experts of its own there, drawn from the
  seed, at ``BAND * (1 + u)`` (u uniform in [0, 1)), and 0 elsewhere;
* the band is the embedding's alone: rows 0..E-1 of every projection
  that writes the residual stream (``o_proj``, every ``down_proj``:
  the dense layer's, the routed and the shared experts') are 0;
* the router reads the band alone: ``mlp.gate.weight[e, e]`` is
  ``ROUTER * (1 + u)``, every other entry 0.

So each token's k experts have router logits above 0 and every other
expert exactly 0: rounding never moves a token to another expert, and
the compared logits read the precision of the arithmetic, not which
side of a near tie a token fell on.  The gates are the softmax's
probabilities themselves (``norm_topk_prob`` false): they vary with the
token and the depth, and sum to less than 1.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

from bench.reference.deepseek_v2 import layer_names
from bench.traffic.mellum2_weights import _seed_of

Q_GAIN = 2.0 ** 0.5
EXPERT_GAIN = 3.0
BAND = 1.0
ROUTER = 2.0


class Weights(Mapping):
    """The checkpoint's tensors by name, each drawn when read."""

    def __init__(self, config: dict, seed: int, device):
        self.config, self.seed = config, int(seed)
        self.device = torch.device(device)
        D, H = int(config["hidden_size"]), int(config["num_attention_heads"])
        R, dn = int(config["kv_lora_rank"]), int(config["qk_nope_head_dim"])
        dr, dv = int(config["qk_rope_head_dim"]), int(config["v_head_dim"])
        E, F = int(config["n_routed_experts"]), \
            int(config["moe_intermediate_size"])
        Fs = F * int(config.get("n_shared_experts") or 0)
        Fd, V = int(config["intermediate_size"]), int(config["vocab_size"])
        if D < E + 1:
            raise ValueError(f"hidden size {D} leaves no room beside a "
                             f"router band of {E}")
        self.shapes = {"model.embed_tokens.weight": (V, D),
                       "model.norm.weight": (D,),
                       "lm_head.weight": (V, D)}
        per = {"input_layernorm.weight": (D,),
               "post_attention_layernorm.weight": (D,),
               "self_attn.kv_a_layernorm.weight": (R,),
               "self_attn.q_proj.weight": (H * (dn + dr), D),
               "self_attn.kv_a_proj_with_mqa.weight": (R + dr, D),
               "self_attn.kv_b_proj.weight": (H * (dn + dv), R),
               "self_attn.o_proj.weight": (D, H * dv),
               "mlp.gate.weight": (E, D)}
        for i in range(int(config["num_hidden_layers"])):
            for name in layer_names(config, i):
                part = name.split(".", 3)[3]
                if part in per:
                    self.shapes[name] = per[part]
                    continue
                width = Fd if part.startswith("mlp.") and part.count(".") \
                    == 2 else Fs if ".shared_experts." in part else F
                self.shapes[name] = (D, width) if part.endswith(
                    "down_proj.weight") else (width, D)

    def __len__(self) -> int:
        return len(self.shapes)

    def __iter__(self):
        return iter(self.shapes)

    def __getitem__(self, name: str) -> torch.Tensor:
        shape = self.shapes[name]
        g = torch.Generator(device=self.device).manual_seed(
            _seed_of(self.seed, name))
        E = int(self.config["n_routed_experts"])

        def normal(scale):
            return torch.randn(shape, generator=g, device=self.device
                               ).mul_(scale)

        def uniform(lo, hi):
            return torch.rand(shape, generator=g, device=self.device
                              ).mul_(hi - lo).add_(lo)

        if name.endswith("norm.weight"):
            w = uniform(0.75, 1.25)
        elif name == "model.embed_tokens.weight":
            w = normal(1.0)
            k = int(self.config["num_experts_per_tok"])
            mine = torch.rand((shape[0], E), generator=g, device=self.device
                              ).argsort(-1)[:, :k]
            level = torch.rand(mine.shape, generator=g, device=self.device)
            w[:, :E] = 0
            w[:, :E].scatter_(1, mine, BAND * (1 + level))
        elif name.endswith("mlp.gate.weight"):
            w = torch.zeros(shape, device=self.device)
            w[:, :E] = torch.diag(ROUTER * (1 + torch.rand(
                E, generator=g, device=self.device)))
        else:
            gain = Q_GAIN if name.endswith("q_proj.weight") else \
                EXPERT_GAIN if ".experts." in name and name.endswith(
                    "down_proj.weight") else 1.0
            w = normal(gain * shape[1] ** -0.5)
            if name.endswith(("o_proj.weight", "down_proj.weight")):
                w[:E] = 0
        return w.to(torch.bfloat16)
