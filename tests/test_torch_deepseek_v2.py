"""deepseek-v2-lite on the CPU at its smoke size (float32): the port's
serving path (prefill through the decompressed latent attention, then
decode over the latent rings in the absorbed form, as
``launch.serve.generate`` runs them), on weights drawn in the published
layout and loaded through ``params_from_published``, against the
benchmark's plain reference ``bench/reference/deepseek_v2.py``; the
absorbed decode against the decompressed form for one layer; the
loader's de-interleave of the rope rows; the dense first layer; faults
planted in the program that the comparison must catch; and the defaults
of the new arguments leaving the shared paths (Mellum2's) as they
were."""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import set_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import generate
from repro_torch.models import blocks as PB
from repro_torch.models import init_params, params_from_published
from repro_torch.models import layers as PL
from repro_torch.models.config import RopeConfig
from repro_torch.obs import Tracer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench.loops.serve_mla import as_published  # noqa: E402
from bench.reference import deepseek_v2 as ref  # noqa: E402
from bench.traffic.deepseek_v2_weights import Weights  # noqa: E402

ARCH = "deepseek-v2-lite"
# float32 on both sides: the products sum in other orders (the absorbed
# decode, grouped experts) over 3 layers; the program reads 1e-6 here
REL = 1e-4
# a planted fault must move the logits 100 times further than that
FAULT = 1e-2


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    try:
        yield
    finally:
        set_device(prev)


def rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


class _MetaGen(torch.Generator):
    @property
    def device(self):
        return torch.device("meta")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def test_full_config_widths_and_count():
    cfg = get_config("DeepSeek-V2-Lite")
    assert get_config(ARCH) is cfg
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab, cfg.d_ff,
            cfg.first_dense) == (27, 2048, 16, 102400, 10944, 1)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.latent_dim) == (512, 128, 64, 128, 576)
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.d_expert, m.d_shared,
            m.norm_topk_prob, m.dropless) == \
        (64, 6, 1408, 2816, False, True)
    r = cfg.rope_global
    assert (r.kind, r.factor, r.original_max_position, r.theta) == \
        ("yarn", 40.0, 4096, 10_000.0)
    # m = 0.1 * 0.707 * ln 40 + 1 = 1.26082: the softmax takes m², cos
    # and sin m / m
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.26082, abs=5e-5)
    assert r.softmax_factor == pytest.approx(m * m, rel=1e-12)
    assert r.cos_sin_factor == 1.0
    # n_params() leaves out the final norm, as the JAX package's does
    assert cfg.n_params() + cfg.d_model == 15_706_484_224
    tree = init_params(cfg, _MetaGen())
    assert sum(t.numel() for t in _leaves(tree)) == 15_706_484_224


def served(cfg, weights=None, prompt=48, new=6, seed=3):
    """``generate`` over two id prompts on published weights drawn from
    ``seed``, and the reference's logits over prompt + new tokens."""
    pub = as_published(smoke_config(ARCH))
    weights = weights or Weights(pub, seed, "cpu")
    params = params_from_published(cfg, weights)
    ids = torch.randint(0, cfg.vocab, (2, prompt),
                        generator=torch.Generator().manual_seed(prompt))
    out = generate(cfg, params, ids, max_new=new, s_max=prompt + new,
                   details=True)
    wants = ref.forward(Weights(pub, seed, "cpu"),
                        [torch.cat([ids[r], out.tokens[r]])
                         for r in range(2)], pub, last=new + 1)
    return out, wants


def worst(out, wants) -> float:
    return max(rel(torch.stack([lg[r] for lg in out.logits]), want)
               for r, want in enumerate(wants))


def test_generate_agrees_with_reference():
    """Prefill (the flash path: the prompt a multiple of the attention
    block) and decode through the latent rings against the reference's
    full forward over prompt + generated tokens, every position."""
    cfg = smoke_config(ARCH)
    assert cfg.attention_impl == "pallas" and cfg.is_mla
    lat0 = PB.attn_decode_counts()["latent"]
    out, wants = served(cfg, prompt=32, new=5)
    assert out.tokens.shape == (2, 5) and len(out.logits) == 6
    assert PB.attn_decode_counts()["latent"] - lat0 == 5 * cfg.n_layers
    for r, want in enumerate(wants):
        got = torch.stack([lg[r] for lg in out.logits])
        assert rel(got[0], want[0]) < REL
        assert rel(got[1:], want[1:]) < REL
        assert torch.equal(got[:-1].argmax(-1), out.tokens[r])


def test_absorbed_decode_equals_decompressed_form():
    """One layer: prefill over S positions, then one decode step over the
    latent ring (W_UK folded into the query, W_UV after the attention)
    gives what the decompressed form over S + 1 positions gives at the
    last one; the ring holds the latent row of every position."""
    cfg = smoke_config(ARCH)
    p = PB.init_mla(cfg, torch.Generator().manual_seed(2))
    x = torch.randn((2, 13, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    pos = torch.arange(13, dtype=torch.int32).expand(2, 13)
    full, _ = PB.apply_mla(p, x, PB.Ctx(pos, "train"), cfg)
    cache = PB.init_latent_cache(cfg, 2, 16, torch.device("cpu"))
    _, cache = PB.apply_mla(p, x[:, :12], PB.Ctx(pos[:, :12], "prefill",
                                                  cache), cfg)
    assert cache.ring.shape == (2, 16, cfg.latent_dim)
    assert cache.pos[0].tolist() == list(range(12)) + [-1] * 4
    step, cache = PB.apply_mla(p, x[:, 12:], PB.Ctx(pos[:, 12:], "decode",
                                                     cache), cfg)
    assert cache.index == 13 and int(cache.pos[0, 12]) == 12
    assert rel(step[:, 0], full[:, 12]) < 1e-5


def test_loader_deinterleaves_the_rope_rows():
    """The published rope rows (each q head's last dr, the kv_a
    projection's last dr) stored as (pair, 2) are loaded even rows
    first, then odd; every other row as it is."""
    cfg = smoke_config(ARCH)
    w = Weights(as_published(cfg), 5, "cpu")
    p = params_from_published(cfg, w, torch.float32)["layers"][1]["attn"]
    dn, dr, R = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    order = list(range(0, dr, 2)) + list(range(1, dr, 2))
    q = w["model.layers.1.self_attn.q_proj.weight"].float().view(
        cfg.n_heads, dn + dr, -1)
    want = torch.cat([q[:, :dn], q[:, dn:][:, order]], 1).reshape(
        -1, q.shape[-1])
    assert torch.equal(p["wq"], want.T)
    a = w["model.layers.1.self_attn.kv_a_proj_with_mqa.weight"].float()
    assert torch.equal(p["wkv_a"][:, :R], a[:R].T)
    assert torch.equal(p["wkv_a"][:, R:], a[R:][order].T)
    assert torch.equal(p["kv_ln"] + 1, w[
        "model.layers.1.self_attn.kv_a_layernorm.weight"].float())


def test_first_layer_dense_the_rest_sparse():
    """Layer 0 a SwiGLU of width d_ff; the others the router, the
    routed experts and the shared experts, each traced call opening
    ``moe.route``, ``moe.experts`` and ``moe.shared``, and every layer
    one ``attn.mla``."""
    cfg = smoke_config(ARCH)
    params = params_from_published(cfg, Weights(as_published(cfg), 6,
                                                 "cpu"))
    mlps = [lay["mlp"] for lay in params["layers"]]
    assert set(mlps[0]) == {"ln", "w_gate", "w_up", "w_down"}
    assert mlps[0]["w_gate"].shape == (cfg.d_model, cfg.d_ff)
    for m in mlps[1:]:
        assert set(m) == {"ln", "router", "w_gate", "w_up", "w_down",
                          "shared"}
        assert m["shared"]["w_down"].shape == (cfg.moe.d_shared,
                                               cfg.d_model)
    tracer = Tracer()
    root = tracer.start("call")
    with root:
        generate(cfg, params, torch.zeros((1, 16), dtype=torch.int64),
                 max_new=2, s_max=18)
    names = [s["name"] for s in tracer.spans(root.trace_id)]
    steps = 3                                   # prefill and two steps
    assert names.count("attn.mla") == steps * cfg.n_layers
    for n in ("moe.route", "moe.experts", "moe.shared"):
        assert names.count(n) == steps * (cfg.n_layers - 1), n
    tags = [s["tags"] for s in tracer.spans(root.trace_id)
            if s["name"] == "attn.mla"]
    assert tags[0] == {"form": "decompressed", "batch": 1, "tokens": 16,
                       "keys": 16}
    assert tags[-1] == {"form": "absorbed", "batch": 1, "tokens": 1,
                        "keys": 18}


def _no_m_squared(mp, cfg):
    mp.setattr(RopeConfig, "softmax_factor", property(lambda self: 1.0))
    return cfg


def _gates_renormalized(mp, cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, norm_topk_prob=True))


def _shared_experts_dropped(mp, cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            d_shared=0))


def _rope_over_every_dim(mp, cfg):
    orig = PL.rope
    mp.setattr(PL, "rope", lambda x, positions, theta=10_000.0,
               rotary_dims=0: orig(x, positions, theta))
    return cfg


class _Interleaved(Weights):
    """The published tensors with their rope rows put back into the
    de-interleaved order, which the loader then reads as if interleaved:
    the program's rope rows left as stored."""

    def __getitem__(self, name):
        w = super().__getitem__(name)
        dr = int(self.config["qk_rope_head_dim"])
        width = {"q_proj": int(self.config["qk_nope_head_dim"]) + dr,
                 "kv_a_proj_with_mqa": int(self.config["kv_lora_rank"])
                 + dr}.get(name.split(".")[-2])
        if width is None:
            return w
        blocks = w.view(-1, width, w.shape[-1]).clone()
        rot = blocks[:, width - dr:].clone()
        blocks[:, width - dr:][:, 0::2] = rot[:, :dr // 2]
        blocks[:, width - dr:][:, 1::2] = rot[:, dr // 2:]
        return blocks.view_as(w)


@pytest.mark.parametrize("fault", [
    _no_m_squared, _gates_renormalized, _shared_experts_dropped,
    _rope_over_every_dim, "rope_rows_interleaved"],
    ids=lambda f: f if isinstance(f, str) else f.__name__.strip("_"))
def test_a_planted_fault_fails_the_comparison(fault, monkeypatch):
    cfg = smoke_config(ARCH)
    weights = None
    if fault == "rope_rows_interleaved":
        weights = _Interleaved(as_published(cfg), 3, "cpu")
    else:
        cfg = fault(monkeypatch, cfg)
    out, wants = served(cfg, weights, prompt=16, new=3)
    assert worst(out, wants) > FAULT


# -- the shared paths' defaults ---------------------------------------------

def test_flash_default_scale_and_equal_widths_as_before():
    """``flash_attention`` with no ``scale`` is the call it was: the
    scale Dh^-0.5 passed to the same arithmetic, bit for bit."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 32, 4, 16), generator=g) for _ in range(3))
    got = flash_attention(q, k, v, causal=True, window=8)
    assert torch.equal(got, flash_attention(q, k, v, causal=True, window=8,
                                            scale=16 ** -0.5))
    pos = torch.arange(32).expand(2, 32)
    assert torch.equal(got, PL.attention_naive(q, k, v, pos, pos, True, 8))


def test_attention_decode_equal_widths_as_before():
    """``attention_decode`` with equal key and value widths and no
    ``scale`` is the call it was; with a narrower value view of the
    key ring (the absorbed form's) it is the naive attention over the
    same values."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 1, 8, 24), generator=g)
    ring = torch.randn((2, 20, 2, 24), generator=g)
    v = torch.randn((2, 20, 2, 24), generator=g)
    qp = torch.full((2, 1), 19)
    kp = torch.arange(20).expand(2, 20).clone()
    kp[1, 15:] = -1
    got = PL.attention_decode(q, ring, v, qp, kp)
    assert torch.equal(got, PL.attention_decode(q, ring, v, qp, kp,
                                                scale=24 ** -0.5))
    torch.testing.assert_close(
        got, PL.attention_naive(q, ring, v, qp, kp), rtol=2e-6, atol=2e-6)
    narrow = PL.attention_decode(q, ring, ring[..., :16], qp, kp, scale=0.3)
    torch.testing.assert_close(narrow, PL.attention_naive(
        q, ring, F.pad(ring[..., :16], (0, 8)), qp, kp, scale=0.3
    )[..., :16], rtol=2e-6, atol=2e-6)


def _grouped_as_before(p, x, cfg):
    """``apply_moe_grouped`` as it was before shared experts and
    unrenormalized gates: renormalized top-k gates, no shared term."""
    m = cfg.moe
    B, S, D = x.shape
    T, k = B * S, m.top_k
    h = PL.rms_norm(x, PB._c(p["ln"], cfg), cfg.norm_eps).reshape(T, D)
    logits = h.to(torch.float32) @ p["router"].to(torch.float32)
    gate, expert = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    flat = expert.reshape(-1)
    order = torch.argsort(flat, stable=True)
    _, ends = PB.expert_rows(flat, m.n_experts)
    xs = h.index_select(0, order // k)
    g = torch._grouped_mm(xs, PB._c(p["w_gate"], cfg), offs=ends)
    u = torch._grouped_mm(xs, PB._c(p["w_up"], cfg), offs=ends)
    y = torch._grouped_mm(F.silu(g).mul_(u), PB._c(p["w_down"], cfg),
                          offs=ends)
    y = y.index_select(0, torch.argsort(order)).view(T, k, D)
    return x + y.mul_(gate.to(y.dtype)[..., None]).sum(1).reshape(B, S, D)


def test_grouped_moe_defaults_as_before():
    """Mellum2's MoE (no shared experts, renormalized gates) computes
    what the grouped path computed before, bit for bit."""
    cfg = smoke_config("mellum2-12b-a2.5b")
    m = cfg.moe
    assert (m.d_shared, m.norm_topk_prob) == (0, True)
    p = PB.init_moe(cfg, torch.Generator().manual_seed(4))
    assert "shared" not in p
    x = torch.randn((2, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    assert torch.equal(PB.apply_moe_grouped(p, x, cfg),
                       _grouped_as_before(p, x, cfg))
