"""Mellum2's weights drawn from a run's seed, in the published layout.

``Weights(config, seed, device)`` maps each name of the checkpoint
(the names and conventions ``bench/reference/mellum2.py`` reads) to a
bfloat16 tensor on ``device``, drawn from its own generator, seeded by
the run's seed and the name, each time it is read: the program loads
them once through its own loader, and the reference reads the same
values again after the timed window, so the card never holds two
copies.  Nothing here imports the program.

The draw, per tensor (D the hidden size, E the experts, k a token's):

* projections: normal, scaled by fan-in to the -1/2, but q and k by
  ``QK_GAIN`` times that, so a query meets a key with a score of spread
  ``QK_GAIN ** 2`` (1 at fan-in scale, where attention over thousands
  of random keys comes out as their plain mean, the same whatever the
  window or the rope), and the experts' ``down_proj`` by
  ``EXPERT_GAIN`` times it, so the sparse MLP writes about as much into
  the residual stream as attention does (at fan-in scale the 8 gated
  experts add a quarter of it, and a token's 8th expert hardly shows);
* RMSNorm weights: uniform in [0.75, 1.25);
* the embedding: normal, except on dimensions 0..E-1 (the router's
  band): each token id has k experts of its own there, drawn from the
  seed, at ``BAND * (1 + u)`` (u uniform in [0, 1)), and 0 elsewhere;
* the band is the embedding's alone: rows 0..E-1 of every projection
  that writes the residual stream (``o_proj``, the experts'
  ``down_proj``) are 0;
* the router reads the band alone: ``mlp.gate.weight[e, e]`` is
  ``ROUTER * (1 + u)``, every other entry 0.

So each token's k experts have router logits above 0 and every other
expert exactly 0: rounding never moves a token to another expert, and
the compared logits read the precision of the arithmetic, not which
side of a near tie a token fell on (with a plain random router, 64
experts leave the 8th and 9th about 0.08 of a logit's spread apart, and
bfloat16 flips some token in most positions' past over 28 layers).  The
gates still vary with the token and with the depth (the norm divides
the band by the residual's size).
"""
from __future__ import annotations

import hashlib
from collections.abc import Mapping

import torch

from bench.reference.mellum2 import layer_names

QK_GAIN = 2.0 ** 0.5
EXPERT_GAIN = 3.0
BAND = 1.0
ROUTER = 2.0


def _seed_of(seed: int, name: str) -> int:
    digest = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") & ((1 << 63) - 1)


class Weights(Mapping):
    """The checkpoint's tensors by name, each drawn when read."""

    def __init__(self, config: dict, seed: int, device):
        self.config, self.seed = config, int(seed)
        self.device = torch.device(device)
        D = int(config["hidden_size"])
        H, KV = int(config["num_attention_heads"]), \
            int(config["num_key_value_heads"])
        Dh = int(config.get("head_dim") or D // H)
        E, F = int(config["num_experts"]), \
            int(config["moe_intermediate_size"])
        V = int(config["vocab_size"])
        if D < E + 1:
            raise ValueError(f"hidden size {D} leaves no room beside a "
                             f"router band of {E}")
        self.shapes = {"model.embed_tokens.weight": (V, D),
                       "model.norm.weight": (D,),
                       "lm_head.weight": (V, D)}
        per = {"input_layernorm.weight": (D,),
               "post_attention_layernorm.weight": (D,),
               "mlp.gate.weight": (E, D),
               "self_attn.q_proj.weight": (H * Dh, D),
               "self_attn.k_proj.weight": (KV * Dh, D),
               "self_attn.v_proj.weight": (KV * Dh, D),
               "self_attn.o_proj.weight": (D, H * Dh)}
        for i in range(len(config["layer_types"])):
            for name in layer_names(config, i):
                part = name.split(".", 3)[3]
                if ".experts." in part:
                    proj = part.rsplit(".", 2)[1]
                    self.shapes[name] = (D, F) if proj == "down_proj" \
                        else (F, D)
                else:
                    self.shapes[name] = per[part]

    def __len__(self) -> int:
        return len(self.shapes)

    def __iter__(self):
        return iter(self.shapes)

    def __getitem__(self, name: str) -> torch.Tensor:
        shape = self.shapes[name]
        g = torch.Generator(device=self.device).manual_seed(
            _seed_of(self.seed, name))
        E = int(self.config["num_experts"])

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
            gain = QK_GAIN if name.endswith(("q_proj.weight",
                                             "k_proj.weight")) else \
                EXPERT_GAIN if name.endswith("down_proj.weight") else 1.0
            w = normal(gain * shape[1] ** -0.5)
            if name.endswith(("o_proj.weight", "down_proj.weight")):
                w[:E] = 0
        return w.to(torch.bfloat16)
