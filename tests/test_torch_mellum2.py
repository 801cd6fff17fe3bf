"""mellum2-12b-a2.5b on the CPU at its smoke size (float32): the port's
serving path (prefill, then decode through the caches, as
``launch.serve.generate`` runs them), on weights drawn in the published
layout and loaded through ``params_from_published``, against the
benchmark's plain reference ``bench/reference/mellum2.py``, which reads
the published tensors; YaRN's frequencies against the formula written
out; each attention layer kind's rope; the dropless grouped MoE against
the reference when one expert takes every token; granite-moe's capacity
path unchanged."""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import set_device
from repro_torch.launch.serve import generate
from repro_torch.models import blocks as PB
from repro_torch.models import init_params, params_from_published
from repro_torch.models import layers as PL
from repro_torch.models.config import RopeConfig, rope_for
from repro_torch.obs import REGISTRY, Tracer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench.reference import mellum2 as ref  # noqa: E402
from bench.traffic.mellum2_weights import Weights  # noqa: E402

ARCH = "mellum2-12b-a2.5b"
# float32 on both sides: the products sum in other orders (blocked
# attention, grouped experts) over 9 layers
REL = 1e-4
KINDS = {"L": "sliding_attention", "A": "full_attention"}


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    try:
        yield
    finally:
        set_device(prev)


def published(cfg) -> dict:
    """``cfg`` under the keys of the published config.json."""
    def rope(r):
        out = {"rope_type": r.kind, "rope_theta": r.theta}
        if r.kind == "yarn":
            out.update(factor=r.factor, beta_fast=r.beta_fast,
                       beta_slow=r.beta_slow, attention_factor=(
                           r.attention_factor),
                       original_max_position_embeddings=(
                           r.original_max_position))
        return out
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "vocab_size": cfg.vocab,
            "layer_types": [KINDS[t] for t in cfg.layer_types()],
            "sliding_window": cfg.window, "rms_norm_eps": cfg.norm_eps,
            "rope_parameters": {k: rope(rope_for(cfg, t))
                                for t, k in KINDS.items()},
            "num_experts": cfg.moe.n_experts,
            "num_experts_per_tok": cfg.moe.top_k,
            "moe_intermediate_size": cfg.moe.d_expert,
            "norm_topk_prob": True}


def rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


def test_full_config_widths_and_count():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.vocab, cfg.window) == \
        (28, 2304, 32, 4, 128, 98304, 1024)
    assert "".join(cfg.layer_types()) == "LLLA" * 7
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert,
            cfg.moe.dropless) == (64, 8, 896, True)
    # n_params() leaves out the final norm, as the JAX package's does
    assert cfg.n_params() + cfg.d_model == 12_149_915_904
    tree = init_params(cfg, _MetaGen())
    assert sum(t.numel() for t in _leaves(tree)) == 12_149_915_904


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


@pytest.mark.parametrize("prompt", [48, 64])
def test_generate_agrees_with_reference(prompt):
    """Prefill (the flash path: the prompt a multiple of the attention
    block) and decode through the rings, the prompt three or four times
    the smoke window so the sliding layers' rings wrap, against the
    reference's full forward over prompt + generated tokens."""
    cfg = smoke_config(ARCH)
    assert prompt > 2 * cfg.window and cfg.attention_impl == "pallas"
    weights = Weights(published(cfg), 3, "cpu")
    params = params_from_published(cfg, weights)
    ids = torch.randint(0, cfg.vocab, (2, prompt),
                        generator=torch.Generator().manual_seed(prompt))
    new = 6
    out = generate(cfg, params, ids, max_new=new, s_max=prompt + new,
                   details=True)
    assert out.tokens.shape == (2, new) and len(out.logits) == new + 1
    wants = ref.forward(weights, [torch.cat([ids[r], out.tokens[r]])
                                  for r in range(2)], published(cfg),
                        last=new + 1)
    for r, want in enumerate(wants):
        got = torch.stack([lg[r] for lg in out.logits])
        assert rel(got[0], want[0]) < REL
        assert rel(got[1:], want[1:]) < REL
        # greedy: each new token is the argmax of the step before
        assert torch.equal(got[:-1].argmax(-1), out.tokens[r])


def test_generate_ids_and_strings_share_a_path():
    cfg = smoke_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(5))
    texts = generate(cfg, params, ["ip.src|1.1.1.1"], max_new=4)
    from repro_torch.data import tokenizer as T
    ids = torch.as_tensor(T.encode("ip.src|1.1.1.1")).clamp_max(
        cfg.vocab - 1)[None]
    got = generate(cfg, params, ids, max_new=4)
    assert got.shape == (1, 4)
    assert texts == [T.decode(got[0].numpy())]


def yarn_by_hand(theta, dim, factor, orig, beta_fast, beta_slow):
    """YaRN's inverse frequencies, written out: dimension i (of dim/2)
    turns theta^(-2i/dim) radians a position; the dimension that turns
    n times over the original context is
    dim·ln(orig / (2πn)) / (2 ln theta).  Below the beta_fast dimension
    (floored) a frequency is kept, above the beta_slow one (ceiled) it is
    divided by ``factor``, and linearly between."""
    out = []
    d_fast = math.floor(dim * math.log(orig / (2 * math.pi * beta_fast))
                        / (2 * math.log(theta)))
    d_slow = math.ceil(dim * math.log(orig / (2 * math.pi * beta_slow))
                       / (2 * math.log(theta)))
    for i in range(dim // 2):
        f = theta ** (-2 * i / dim)
        t = min(max((i - d_fast) / (d_slow - d_fast), 0.0), 1.0)
        out.append(f * (1 - t) + f / factor * t)
    return torch.tensor(out, dtype=torch.float64)


def test_yarn_inv_freq_and_scale_equal_the_formula():
    r = rope_for(get_config(ARCH), "A")
    assert (r.kind, r.theta, r.factor, r.original_max_position) == \
        ("yarn", 500_000.0, 16.0, 8192)
    want = yarn_by_hand(500_000.0, 128, 16.0, 8192, 32.0, 1.0)
    got = PL.rope_inv_freq(r, 128).to(torch.float64)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    # the fast dims keep their frequency, the slow ones are divided by 16
    assert got[0] == 1.0 and torch.isclose(got[-1], want[-1])
    assert r.attention_factor == pytest.approx(0.1 * math.log(16) + 1)
    # rope scales cos and sin by the attention factor: a rotation's norm
    x = torch.randn(1, 5, 2, 128, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(5)[None]
    y = PL.rope(x, pos, r)
    torch.testing.assert_close(y.norm(dim=-1),
                               x.norm(dim=-1) * r.attention_factor)
    inv = want.to(torch.float32)
    ang = pos[0, :, None].float() * inv
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[0, ..., :64], x[0, ..., 64:]
    by_hand = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1) * \
        r.attention_factor
    torch.testing.assert_close(y[0], by_hand, rtol=1e-5, atol=1e-5)
    # the reference writes the same formula out on its own
    inv_ref, scale = ref.rope_inv_freq(published(get_config(ARCH))[
        "rope_parameters"]["full_attention"], 128)
    torch.testing.assert_close(inv_ref.to(torch.float64), want,
                               rtol=1e-6, atol=0)
    assert scale == r.attention_factor


def test_each_layer_kind_gets_its_own_rope(monkeypatch):
    cfg = smoke_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(2))
    seen = []
    orig = PL.rope

    def spy(x, positions, theta=10_000.0):
        seen.append(theta)
        return orig(x, positions, theta)
    monkeypatch.setattr(PL, "rope", spy)
    generate(cfg, params, torch.zeros((1, 16), dtype=torch.int64),
             max_new=1, s_max=17)
    kinds = cfg.layer_types()
    # q and k of every layer, in the prefill and the decode step
    assert len(seen) == 2 * 2 * len(kinds)
    for i, r in enumerate(seen):
        kind = kinds[(i // 2) % len(kinds)]
        assert isinstance(r, RopeConfig)
        if kind == "A":
            assert r.kind == "yarn" and r.attention_factor > 1
        else:
            assert r == RopeConfig(theta=500_000.0)
    # every config the JAX package has keeps its default rope
    for arch in ("granite-moe-3b-a800m", "recurrentgemma-9b",
                 "h2o-danube-1.8b", "qwen3-moe-235b-a22b"):
        c = get_config(arch)
        assert rope_for(c, "A") == rope_for(c, "L") == \
            RopeConfig(theta=c.rope_theta)
        assert not c.moe or not c.moe.dropless


def test_one_expert_takes_every_token_and_drops_nothing():
    """A router forced to put expert 0 first for every token: the
    dropless path computes every pair (the capacity path at the same
    size drops most of them) and equals the reference's sparse MLP; a
    traced call counts the pairs an expert."""
    cfg = smoke_config(ARCH)
    D, E = cfg.d_model, cfg.moe.n_experts
    g = torch.Generator().manual_seed(9)
    p = PB.init_moe(cfg, g)
    p["router"][:, 0] = 10.0            # h > 0 below: expert 0 wins
    x = torch.rand((2, 40, D), generator=g) + 0.1
    got = PB.apply_moe(p, x, cfg)
    h = PL.rms_norm(x, p["ln"], cfg.norm_eps).reshape(-1, D)
    probs = torch.softmax(h @ p["router"], -1)
    assert bool((probs.argmax(-1) == 0).all())
    lw = {"mlp.gate.weight": p["router"].T}
    for e in range(E):
        for proj, w in (("gate", "w_gate"), ("up", "w_up"),
                        ("down", "w_down")):
            lw[f"mlp.experts.{e}.{proj}_proj.weight"] = p[w][e].T
    want = x + ref._moe(h, lw, published(cfg), ref._Products()).reshape(
        x.shape)
    assert rel(got, want) < 1e-5
    tight = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dropless=False, capacity_factor=1.0))
    assert rel(PB.apply_moe(p, x, tight), want) > 1e-2
    fam = REGISTRY.counter("repro_moe_pairs_total", labels=("expert",))
    before = {e: fam.labels(expert=e).value for e in range(E)}
    tracer = Tracer()
    root = tracer.start("call")
    with root:
        PB.apply_moe(p, x, cfg)
    spans = {s["name"]: s for s in tracer.spans(root.trace_id)}
    k = cfg.moe.top_k
    assert spans["moe.experts"]["tags"]["rows"] == 80 * k
    assert spans["moe.route"]["tags"]["experts_hit"] == \
        spans["moe.experts"]["tags"]["experts_hit"] >= 1
    after = {e: fam.labels(expert=e).value for e in range(E)}
    assert after[0] - before[0] == 80
    assert sum(after.values()) - sum(before.values()) == 80 * k


def test_kv_cache_bytes_by_kind():
    cfg = smoke_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(4))
    generate(cfg, params, torch.zeros((2, 48), dtype=torch.int64),
             max_new=1, s_max=64)
    kv = {dict(lbl)["kind"]: v for (name, lbl), v in
          REGISTRY.as_dict().items() if name == "repro_kv_cache_bytes"}
    ring = 2 * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 4   # K+V, f32
    n_l = cfg.layer_types().count("L")
    assert kv == {"window": n_l * ring * cfg.window,
                  "full": (cfg.n_layers - n_l) * ring * 64}


def test_flash_runs_every_prefill_layer_with_its_window(monkeypatch):
    """28 flash calls a prefill at full depth: one an attention layer,
    the sliding layers with their window; none in decode."""
    cfg = smoke_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(6))
    windows = []
    orig = PL.flash_attention

    def spy(q, k, v, causal=True, window=0):
        windows.append(window)
        return orig(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(PL, "flash_attention", spy)
    generate(cfg, params, torch.zeros((2, 48), dtype=torch.int64),
             max_new=3, s_max=51)
    assert windows == [cfg.window if t == "L" else 0
                       for t in cfg.layer_types()]


# granite-moe's smoke prefill and four decode steps (seeds below), read
# at the commit before the dropless path was added
GRANITE_IDS = [[196, 129], [142, 254], [30, 145], [249, 249], [145, 249]]
GRANITE_ABS_SUM = 2029.0849609375
GRANITE_FIRST = [
    [-2.5473904609680176, 1.957883596420288, -0.8178185224533081],
    [-0.293502539396286, -0.5882166624069214, -0.6506490707397461],
    [0.05115079879760742, -0.058728545904159546, -0.045689016580581665],
    [-0.29550647735595703, 0.4448658227920532, 0.6874854564666748],
    [1.3064329624176025, 0.30669015645980835, 1.1541414260864258]]


def test_granite_moe_smoke_outputs_unchanged():
    from repro_torch.models import decode_step, prefill
    cfg = smoke_config("granite-moe-3b-a800m")
    assert not cfg.moe.dropless
    params = init_params(cfg, torch.Generator().manual_seed(7))
    toks = torch.randint(0, cfg.vocab, (2, 24), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(11)
                         ).to(torch.int32)
    logits, caches = prefill(params, {"tokens": toks}, cfg, s_max=32)
    outs, nxt = [logits[:, -1]], logits[:, -1].argmax(-1)
    ids = [nxt.tolist()]
    for s in range(4):
        logits, caches = decode_step(params, caches, {
            "tokens": nxt[:, None].to(torch.int32),
            "positions": torch.full((2, 1), 24 + s, dtype=torch.int32)}, cfg)
        outs.append(logits[:, -1])
        nxt = logits[:, -1].argmax(-1)
        ids.append(nxt.tolist())
    got = torch.stack(outs)
    assert ids == GRANITE_IDS
    assert float(got.abs().sum()) == pytest.approx(GRANITE_ABS_SUM,
                                                   rel=1e-6)
    torch.testing.assert_close(got[:, 0, :3], torch.tensor(GRANITE_FIRST),
                               rtol=1e-5, atol=1e-6)
