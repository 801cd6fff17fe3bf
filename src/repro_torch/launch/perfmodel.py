"""Analytic per-device performance model (FLOPs / HBM bytes / collective
bytes) for every (arch × shape × mesh) cell — the JAX package's
``launch/perfmodel.py``, the same names and arithmetic, so both packages
give equal numbers for every cell and knob set.

The model reproduces the matmul dimensions the modules lower to — per
device, given the sharding rules.  ``launch/calibrate.py`` compares it
with the per-device FLOPs counted on the local shards of the port's
unit train step (``torch.utils.flop_counter``, matmul-class ops only).
It keeps the JAX package's ``ModelConfig.n_params()``, which counts an
RG-LRU layer without its ``wa`` and ``wi`` gates (Dr × Dr each).

Everything is per device per step.  Knobs are explicit parameters:
attention schedule (masked-full vs triangular), grad dtype, remat
policy, grad accumulation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..configs import get_config
from ..models.config import (ATTN, LOCAL_ATTN, ModelConfig, RGLRU, RWKV,
                             ShapeConfig, shape_by_name)


@dataclasses.dataclass
class MeshDims:
    pod: int = 1
    data: int = 16
    model: int = 16

    @property
    def n_devices(self):
        return self.pod * self.data * self.model

    @property
    def n_data(self):
        return self.pod * self.data


MESH_SINGLE = MeshDims(1, 16, 16)
MESH_MULTI = MeshDims(2, 16, 16)


@dataclasses.dataclass
class PerfKnobs:
    attention_tri: bool = False      # triangular schedule (vs masked-full)
    grad_accum: int = 1
    grad_bytes: int = 4              # f32 grads on the wire (bf16 = 2)
    param_bytes: int = 4             # master params f32
    gather_bytes: int = 4            # dtype gathered over FSDP (bf16 = 2)
    gather_passes: int = 2           # fwd + bwd regather (1 = persisted)
    act_bytes: int = 2               # bf16 activations
    remat: bool = True               # block remat (recompute fwd in bwd)
    save_coll: bool = False          # remat keeps TP-collective outputs
    profile: str = "2d"              # "2d" (FSDP×TP) | "zero3"


@dataclasses.dataclass
class CellPerf:
    flops: float                     # per device per step
    hbm_bytes: float
    coll_bytes: float
    coll_by_kind: dict

    def merged(self, other: "CellPerf") -> "CellPerf":
        kinds = dict(self.coll_by_kind)
        for k, v in other.coll_by_kind.items():
            kinds[k] = kinds.get(k, 0.0) + v
        return CellPerf(self.flops + other.flops,
                        self.hbm_bytes + other.hbm_bytes,
                        self.coll_bytes + other.coll_bytes, kinds)


# ---------------------------------------------------------------------------
# per-layer forward FLOPs (per device)
# ---------------------------------------------------------------------------

def _attn_layer_fwd(cfg: ModelConfig, S: int, B: int, m: MeshDims,
                    k: PerfKnobs, window: int, s_kv: Optional[int] = None,
                    cross: bool = False) -> float:
    """One attention layer forward (qkv + attention + out + mlp)."""
    D = cfg.d_model
    H, KV = cfg.phys_heads, cfg.phys_kv_heads   # padded = shardable
    Dh = cfg.resolved_head_dim
    tp = m.model
    s_kv = s_kv if s_kv is not None else S
    f = 0.0
    # q/k/v + out projections (head dims sharded over tp); k,v read from
    # the kv source (self: S tokens; cross: encoder_seq; decode: 1 new)
    f += 2 * B * S * D * (H * Dh) / tp                  # q
    kv_src = s_kv if cross else (S if S > 1 else 1)
    f += 2 * 2 * B * kv_src * D * (KV * Dh) / tp        # k, v
    f += 2 * B * S * (H * Dh) * D / tp                  # out
    # attention scores + pv
    eff = s_kv
    if window:
        eff = min(window, s_kv)
    if S > 1 and not cross and window == 0:
        # causal self-attention: masked-full does all S·s_kv block pairs,
        # triangular ~half
        pair_frac = 0.5 if k.attention_tri else 1.0
        f += 2 * 2 * B * S * s_kv * pair_frac * (H / tp) * Dh
    elif S > 1 and not cross and window:
        W = min(window, s_kv)
        # triangular+banded: visible pairs = Σ_q min(q+1, W) ≈ W·S − W²/2
        pair_frac = (W * s_kv - W * W / 2) / (S * s_kv) \
            if k.attention_tri else 1.0
        f += 2 * 2 * B * S * s_kv * pair_frac * (H / tp) * Dh
    else:
        f += 2 * 2 * B * S * eff * (H / tp) * Dh
    return f


def _mlp_fwd(cfg: ModelConfig, S: int, B: int, m: MeshDims) -> float:
    if cfg.moe is None:
        return 6 * B * S * cfg.d_model * cfg.d_ff / m.model
    mo = cfg.moe
    T = B * S
    router = 2 * T * cfg.d_model * mo.n_experts          # f32, replicated
    expert = 6 * mo.capacity_factor * T * mo.top_k * \
        cfg.d_model * mo.d_expert / m.model
    return router + expert


def _rglru_fwd(cfg: ModelConfig, S: int, B: int, m: MeshDims) -> float:
    D, Dr, W = cfg.d_model, cfg.d_rnn_resolved, cfg.conv_width
    tp = m.model
    f = 2 * 2 * B * S * D * Dr / tp          # wx, wg
    f += 2 * W * B * S * Dr / tp             # conv
    f += 2 * 2 * B * S * Dr * Dr / tp        # gates wa, wi
    f += 10 * B * S * Dr / tp                # scan combine work
    f += 2 * B * S * Dr * D / tp             # out proj
    return f


def _rwkv_fwd(cfg: ModelConfig, S: int, B: int, m: MeshDims) -> float:
    D, F, Lw = cfg.d_model, cfg.d_ff, cfg.decay_lora
    H = cfg.n_heads
    Dh = D // H
    C = cfg.rwkv_chunk
    tp = m.model
    f = 5 * 2 * B * S * D * D / tp           # r,k,v,g,out projections
    f += 2 * 2 * B * S * D * Lw              # decay lora (replicated)
    # chunked wkv per head: inter/state 4·C·Dh² + intra 4·C²·Dh per chunk
    f += B * S * (H / tp) * (4 * Dh * Dh + 4 * C * Dh)
    # channel mix
    f += 2 * B * S * (2 * D * F + D * D) / tp
    return f


def _layer_fwd(cfg, ltype, S, B, m, k, s_kv=None) -> float:
    if ltype in (ATTN, LOCAL_ATTN):
        window = cfg.window if ltype == LOCAL_ATTN else 0
        f = _attn_layer_fwd(cfg, S, B, m, k, window, s_kv)
        if cfg.cross_attention:
            f += _attn_layer_fwd(cfg, S, B, m, k, 0, cfg.encoder_seq,
                                 cross=True)
        return f + _mlp_fwd(cfg, S, B, m)
    if ltype == RGLRU:
        return _rglru_fwd(cfg, S, B, m) + \
            6 * B * S * cfg.d_model * cfg.d_ff / m.model
    if ltype == RWKV:
        return _rwkv_fwd(cfg, S, B, m)
    raise ValueError(ltype)


def _embed_head_fwd(cfg, S, B, m) -> float:
    V = cfg.padded_vocab
    f = B * S * cfg.d_model                      # embed scale
    f += 2 * B * S * cfg.d_model * V / m.model   # head matmul
    f += 5 * B * S * V / m.model                 # softmax/lse
    return f


def _encoder_fwd(cfg, B, m, k) -> float:
    if not cfg.is_encdec:
        return 0.0
    S = cfg.encoder_seq
    per = _attn_layer_fwd(cfg, S, B, m, k, 0) + \
        6 * B * S * cfg.d_model * cfg.d_ff / m.model
    return cfg.encoder_layers * per


# ---------------------------------------------------------------------------
# HBM + collective bytes (first-order, per device per step)
# ---------------------------------------------------------------------------

def _layer_act_bytes(cfg, S, B, m, k) -> float:
    """Residual-stream traffic per layer (write+read, bf16)."""
    return 2 * B * S * cfg.d_model * k.act_bytes


def train_cell(cfg: ModelConfig, shape: ShapeConfig, m: MeshDims,
               k: PerfKnobs) -> CellPerf:
    if k.profile == "zero3":
        # pure FSDP: the whole mesh is one data axis; tp factors vanish
        m = MeshDims(pod=1, data=m.n_devices, model=1)
    B_glob = shape.global_batch
    S = shape.seq_len
    ga = k.grad_accum
    B_micro = B_glob // m.n_data // ga           # per device micro batch
    L = cfg.n_layers
    P = cfg.n_params()
    P_loc = P / m.n_devices                       # FSDP+TP sharded at rest

    # ---- FLOPs: (fwd + remat recompute + bwd) per micro ----
    # vision archs prepend n_img_tokens patch embeddings to every sequence
    S_eff = S + (cfg.n_img_tokens if cfg.frontend == "vision" else 0)
    fwd_layers = sum(_layer_fwd(cfg, t, S_eff, B_micro, m, k)
                     for t in cfg.layer_types())
    fwd_layers += _encoder_fwd(cfg, B_micro, m, k)
    fwd_head = _embed_head_fwd(cfg, S, B_micro, m)
    mult = 4.0 if k.remat else 3.0               # fwd+recompute+2·bwd
    flops = ga * (mult * fwd_layers + 3.0 * fwd_head)
    flops += 12.0 * P_loc                        # AdamW update

    # ---- HBM bytes ----
    # FSDP: after all-gather each device reads the FULL layer params,
    # 3× per micro (fwd, recompute, bwd) — the dominant traffic for
    # big-model training.  Reads happen in the GATHERED dtype (bf16
    # gathers halve this too).
    hbm = ga * 3 * P * k.gather_bytes
    hbm += ga * L * _layer_act_bytes(cfg, S, B_micro, m, k) * 3
    hbm += ga * 2 * B_micro * S * cfg.padded_vocab / m.model * 4  # logits
    hbm += 3 * P_loc * 4 * 2                     # adam m,v read+write
    hbm += P_loc * k.param_bytes * 2             # param read+write (update)

    # ---- collective bytes ----
    coll = {}
    # FSDP param all-gather (fwd + bwd regather) + grad reduce-scatter.
    # Params are 2-D sharded (data × model): each device only gathers its
    # model-axis shard's data extent → P/tp bytes, not P.
    P_tp = P / m.model
    gathered = P_tp * k.gather_bytes * (m.data - 1) / m.data
    coll["all-gather"] = ga * k.gather_passes * gathered
    coll["reduce-scatter"] = P_tp * k.grad_bytes * (m.data - 1) / m.data
    # cross-pod gradient all-reduce (DP over pod axis) on the local shard
    if m.pod > 1:
        coll["all-reduce-pod"] = 2 * (P / m.n_devices) * k.grad_bytes \
            * (m.pod - 1) / m.pod
    # TP activation all-reduces: ~2 per layer fwd, ×3 passes (fwd/rc/bwd)
    # — or ×2 when remat keeps the collective outputs (save_coll)
    passes = 2 if (k.save_coll or not k.remat) else 3
    act = B_micro * S * cfg.d_model * k.act_bytes
    ring = 2 * (m.model - 1) / m.model
    coll["all-reduce"] = ga * L * 2 * passes * act * ring
    # MoE all-to-all dispatch+combine — only under expert parallelism
    # (hybrid sharding replicates experts: dispatch is shard-local)
    if cfg.moe is not None and cfg.moe.n_experts % m.model == 0:
        tok = B_micro * S * cfg.moe.top_k * cfg.d_model * k.act_bytes
        coll["all-to-all"] = ga * L * 2 * passes * tok \
            * (m.model - 1) / m.model
    total = sum(coll.values())
    return CellPerf(flops, hbm, total, coll)


def serve_cell(cfg: ModelConfig, shape: ShapeConfig, m: MeshDims,
               k: PerfKnobs) -> CellPerf:
    S = shape.seq_len
    B_glob = shape.global_batch
    B = B_glob // m.n_data if B_glob % m.n_data == 0 else B_glob
    replicated_batch = B_glob % m.n_data != 0
    L = cfg.n_layers
    P = cfg.n_params()

    if shape.kind == "prefill":
        S_eff = S + (cfg.n_img_tokens if cfg.frontend == "vision" else 0)
        fwd = sum(_layer_fwd(cfg, t, S_eff, B, m, k)
                  for t in cfg.layer_types())
        fwd += _encoder_fwd(cfg, B, m, k)
        fwd += _embed_head_fwd(cfg, 1, B, m)      # last-token logits
        flops = fwd
        hbm = P * k.param_bytes + L * _layer_act_bytes(cfg, S, B, m, k)
        act = B * S * cfg.d_model * k.act_bytes
    else:  # decode: one token, cache length S
        fwd = sum(_layer_fwd(cfg, t, 1, B, m, k, s_kv=S)
                  for t in cfg.layer_types())
        fwd += _embed_head_fwd(cfg, 1, B, m)
        flops = fwd
        # params + full KV/state cache read per token
        cache = _cache_bytes(cfg, S, B, m, k)
        hbm = P * k.param_bytes + cache + \
            L * 2 * B * cfg.d_model * k.act_bytes
        act = B * cfg.d_model * k.act_bytes

    coll = {}
    ring = 2 * (m.model - 1) / m.model
    coll["all-reduce"] = L * 2 * act * ring
    if replicated_batch:
        pass                                      # batch replicated: no DP
    if cfg.moe is not None:
        Sq = S if shape.kind == "prefill" else 1
        tok = B * Sq * cfg.moe.top_k * cfg.d_model * k.act_bytes
        coll["all-to-all"] = L * 2 * tok * (m.model - 1) / m.model
    total = sum(coll.values())
    return CellPerf(flops, hbm, total, coll)


def _cache_bytes(cfg, S, B, m, k) -> float:
    """Per-device cache traffic for one decode step (read k+v/state)."""
    KV, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    # full cache bytes / model shards (kv-head or head-dim sharded)
    per_layer = {
        ATTN: 2 * B * S * KV * Dh / m.model * k.act_bytes,
        LOCAL_ATTN: 2 * B * min(cfg.window, S) * KV * Dh / m.model
        * k.act_bytes,
        RGLRU: B * cfg.d_rnn_resolved / m.model * 4,
        RWKV: B * cfg.n_heads * (cfg.d_model // cfg.n_heads) ** 2
        / m.model * 4,
    }
    return sum(per_layer[t] for t in cfg.layer_types())


def cell_perf(arch: str, shape_name, mesh_kind: str,
              knobs: Optional[PerfKnobs] = None,
              cfg: Optional[ModelConfig] = None) -> CellPerf:
    from .dryrun import TRAIN_GRAD_ACCUM
    from ..configs import canonical
    cfg = cfg or get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else shape_by_name(shape_name)
    m = MESH_MULTI if mesh_kind == "multi" else MESH_SINGLE
    if knobs is None:
        knobs = PerfKnobs(
            grad_accum=TRAIN_GRAD_ACCUM.get(canonical(arch), 2)
            if shape.kind == "train" else 1)
    if shape.kind == "train":
        return train_cell(cfg, shape, m, knobs)
    return serve_cell(cfg, shape, m, knobs)
