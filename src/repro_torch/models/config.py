"""Model configuration covering the 10 assigned architecture families
(the JAX package's schema, copied so every config resolves in the port;
the port's model code runs the RWKV-6 family and raises for the rest).

One :class:`ModelConfig` schema spans dense / GQA / SWA transformers,
MoE, hybrid (RG-LRU + local attention), RWKV-6, encoder–decoder, and
stub-fronted audio/VLM backbones.  Block composition is declared by
``pattern`` — a per-layer block-type string — so hybrids like
recurrentgemma's (R, R, A) period fall out of config, not code.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# block types
ATTN = "A"        # global attention
LOCAL_ATTN = "L"  # local / sliding-window attention
RGLRU = "R"       # Griffin RG-LRU recurrent block
RWKV = "W"        # RWKV-6 time-mix block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    router: str = "token_choice"    # "token_choice" | "expert_choice"
    router_dtype: str = "float32"
    # True: every (token, expert) pair is computed (the grouped path of
    # ``blocks.apply_moe``); ``capacity_factor`` is then not read
    dropless: bool = False
    # the dropless path's gates: renormalized by the top-k sum
    # (``norm_topk_prob``), else the softmax's own probabilities
    norm_topk_prob: bool = True
    # shared experts, which every token takes: one SwiGLU of width
    # ``d_shared`` (the shared experts' widths together)
    d_shared: int = 0


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    """The rotary embedding of one layer kind.  ``default``: inverse
    frequencies theta^(-2i/Dh).  ``yarn`` (YaRN, arXiv:2309.00071, as
    Hugging Face's ``_compute_yarn_parameters`` has it): each frequency
    blended between itself and itself / ``factor`` over a linear ramp
    from the ``beta_fast`` to the ``beta_slow`` rotation's dimension of
    ``original_max_position``, and cos and sin scaled by
    ``attention_factor``.  DeepSeek's YaRN (``mscale``,
    ``mscale_all_dim`` given) scales cos and sin by
    m(mscale) / m(mscale_all_dim) instead and the softmax by
    m(mscale_all_dim)², with m(s) = 0.1·s·ln(factor) + 1
    (:attr:`cos_sin_factor`, :attr:`softmax_factor`)."""
    theta: float = 10_000.0
    kind: str = "default"               # "default" | "yarn"
    factor: float = 1.0
    original_max_position: int = 0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: float = 1.0
    mscale: float = 0.0                 # 0: not DeepSeek's form
    mscale_all_dim: float = 0.0

    def _m(self, s: float) -> float:
        return 1.0 if self.factor <= 1 else \
            0.1 * s * math.log(self.factor) + 1.0

    @property
    def cos_sin_factor(self) -> float:
        if not (self.mscale or self.mscale_all_dim):
            return self.attention_factor
        return self._m(self.mscale) / self._m(self.mscale_all_dim)

    @property
    def softmax_factor(self) -> float:
        return self._m(self.mscale_all_dim) ** 2 if self.mscale_all_dim \
            else 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # block composition: period string over {A,L,R,W}; tiled to n_layers.
    pattern: str = ATTN
    head_dim: Optional[int] = None          # default d_model // n_heads
    window: int = 4096                      # for L blocks
    moe: Optional[MoEConfig] = None
    # the first ``first_dense`` layers take a dense SwiGLU of width d_ff
    # in place of ``moe`` (DeepSeek's ``first_k_dense_replace``)
    first_dense: int = 0
    # multi-head latent attention (DeepSeek-V2) on the A layers where
    # ``kv_lora_rank`` > 0: the cache holds one (kv_lora_rank +
    # qk_rope_head_dim) latent row a position; q and k heads are
    # qk_nope_head_dim + qk_rope_head_dim wide, v heads v_head_dim; the
    # queries come from one full-rank projection (no q-LoRA)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # enc-dec (whisper): if set, n_layers applies to decoder; encoder below
    encoder_layers: int = 0
    encoder_seq: int = 1500                 # whisper conv-frontend output
    cross_attention: bool = False
    # modality frontend stubs
    frontend: Optional[str] = None          # None | "audio" | "vision"
    n_img_tokens: int = 576                 # vision prefix length
    # head padding: physical head counts padded up so they divide the
    # tensor-parallel axis (Megatron-style). Padded heads' outputs are
    # hard-masked to zero, so the math is exactly the logical config —
    # without it, heads replicate on every device (16× attention flops,
    # measured via launch/calibrate.py).
    head_pad: int = 0               # physical n_heads (0 = no padding)
    kv_pad: int = 0                 # physical n_kv_heads
    # misc arch details
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    # per layer kind (A, L); None = the default rope at rope_theta
    rope_global: Optional[RopeConfig] = None
    rope_local: Optional[RopeConfig] = None
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    # rglru specifics
    d_rnn: Optional[int] = None             # default d_model
    conv_width: int = 4
    rglru_impl: str = "scan"                # "scan" | "pallas" (prefill)
    # rwkv specifics
    decay_lora: int = 64
    rwkv_impl: str = "chunked"              # "scan" | "chunked" | "pallas"
                                            # (the wkv6 kernel, prefill)
    rwkv_chunk: int = 32
    # dtypes
    dtype: str = "bfloat16"
    serve_param_dtype: str = "float32"     # "bfloat16": serving weights
    # implementation knobs (perf-relevant; see EXPERIMENTS.md §Perf)
    attention_impl: str = "chunked"         # "naive" | "chunked" | "pallas"
    attention_chunk: int = 1024
    remat: str = "block"                    # "none" | "block" | "full"
    scan_layers: bool = True
    loss_chunk: int = 0                     # 0 = unchunked cross-entropy

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def latent_dim(self) -> int:
        """Width of an MLA cache row: the latent and the shared rope
        key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def sparse_mlp(self, layer: int) -> bool:
        """Whether layer ``layer`` takes the MoE (past the leading dense
        layers)."""
        return self.moe is not None and layer >= self.first_dense

    @property
    def phys_heads(self) -> int:
        return self.head_pad or self.n_heads

    @property
    def phys_kv_heads(self) -> int:
        return self.kv_pad or self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Physical vocab padded to a multiple of 256 (Megatron-style) so
        the embedding/head shard evenly over the model axis; padded logit
        columns are masked to -inf before the loss/sampling."""
        return (self.vocab + 255) // 256 * 256

    @property
    def d_rnn_resolved(self) -> int:
        return self.d_rnn or self.d_model

    def layer_types(self) -> Tuple[str, ...]:
        """Tile ``pattern`` over n_layers: e.g. 'RRL' × 38 layers →
        R,R,L,R,R,L,...,R,R (truncated final period)."""
        reps = (self.n_layers + len(self.pattern) - 1) // len(self.pattern)
        return tuple((self.pattern * reps)[: self.n_layers])

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends globally (long_500k eligible)."""
        return ATTN not in self.layer_types()

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        H, KV, Dh = (self.phys_heads, self.phys_kv_heads,
                     self.resolved_head_dim)             # physical storage
        total = V * D                                   # embedding
        if not self.tie_embeddings:
            total += D * V                              # lm head
        per_type = {}
        attn = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
        if self.qkv_bias:
            attn += (H + 2 * KV) * Dh
        if self.is_mla:
            R = self.kv_lora_rank
            attn = (D * H * self.qk_head_dim + D * self.latent_dim + R
                    + R * H * (self.qk_nope_head_dim + self.v_head_dim)
                    + H * self.v_head_dim * D)
        mlp = 3 * D * F if self.moe is None else (
            D * self.moe.n_experts
            + self.moe.n_experts * 3 * D * self.moe.d_expert
            + 3 * D * self.moe.d_shared)
        per_type[ATTN] = per_type[LOCAL_ATTN] = attn + mlp + 2 * D
        Dr = self.d_rnn_resolved
        per_type[RGLRU] = (2 * D * Dr + self.conv_width * Dr + 3 * Dr
                           + Dr * D + 2 * D) + mlp
        per_type[RWKV] = (6 * D + 4 * D * D + 2 * D * self.decay_lora
                          + self.decay_lora * D + D
                          + 2 * D) + (2 * D * F + D * D)
        for i, t in enumerate(self.layer_types()):
            total += per_type[t]
            if t in (ATTN, LOCAL_ATTN) and self.moe is not None and \
                    not self.sparse_mlp(i):     # a leading dense layer
                total += 3 * D * F - mlp
        if self.is_encdec:
            enc_attn = attn + 3 * D * F + 2 * D
            total += self.encoder_layers * enc_attn
            total += self.n_layers * (attn + 2 * D)     # cross-attn blocks
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        expert_p = self.moe.n_experts * 3 * self.d_model * self.moe.d_expert
        active_p = self.moe.top_k * 3 * self.d_model * self.moe.d_expert
        n_moe_layers = sum(1 for i, t in enumerate(self.layer_types())
                           if t in (ATTN, LOCAL_ATTN) and self.sparse_mlp(i))
        return full - n_moe_layers * (expert_p - active_p)


def rope_for(cfg, ltype: str) -> RopeConfig:
    """The rope of an attention layer of kind ``ltype`` in ``cfg``: its
    own for the kind, else the default rope at ``rope_theta``."""
    r = cfg.rope_local if ltype == LOCAL_ATTN else cfg.rope_global
    return r or RopeConfig(theta=cfg.rope_theta)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
