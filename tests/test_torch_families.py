"""The MoE, encoder–decoder and vision families in the port against the
JAX package, at the smoke configs in float32, on the same weights (the
JAX tree carried across by ``params_from_jax``) and equal batches
(``make_batch`` of both packages from one seed): granite-moe and
qwen3-moe (token-choice MoE; qwen3's GQA reaches the flash_attention
wrapper), whisper (encoder, cross-attention) and phi-3-vision (an image
prefix).

The JAX package's ``attention_impl="pallas"`` runs its Pallas kernel in
interpret mode; the port's runs the ``flash_attention`` wrapper, which on
CPU tensors is the plain version.

Tolerances, as ``tests/test_torch_models.py`` states them:
* ``LIKE_TOL`` rtol=atol=1e-4 — the same operations in both packages,
  float32 matmuls summed in another order, through a few layers; also
  gradients, as ``tests/test_torch_train.py`` holds them
  (``GRAD_RTOL`` with an atol of 1e-4·max|g| of the leaf);
* ``TF_TOL`` rtol=atol=1e-4 — decode after prefill against a teacher-
  forced forward in the port;
* routing (expert ids, slots, kept pairs) exact: float32 random weights
  give no ties in the top-k;
* the head-padding test within 1e-4 in the loss, the JAX package's own
  limit (``tests/test_models.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import blocks as JB
from repro.models import inputs as JI
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ShapeConfig as JShape
from repro_torch import configs as pconfigs
from repro_torch.device import set_device
from repro_torch.launch import serve as pserve
from repro_torch.models import blocks as PB
from repro_torch.models import inputs as PI
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import params_from_jax
from repro_torch.models.config import ShapeConfig
from repro_torch.tree import tree_leaves, tree_unflatten

from _config_schema import port_config

LIKE_TOL = dict(rtol=1e-4, atol=1e-4)
TF_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4          # atol x max|g| of the leaf
ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "whisper-large-v3",
         "phi-3-vision-4.2b")
MOE = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
PATHS = {"plain": "chunked", "kernels": "pallas"}   # attention_impl
PERTURB = ("ln", "final_norm", "bq", "bk", "bv")
# the parameter tensors of each full config (the JAX package's
# abstract_params, counted on the CPU)
FULL_COUNTS = {"granite-moe-3b-a800m": 3_349_513_728,
               "whisper-large-v3": 2_398_169_600,
               "phi-3-vision-4.2b": 3_831_696_384,
               "qwen3-moe-235b-a22b": 235_094_659_072}
B, S = 2, 32


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@functools.cache
def family_weights(arch):
    """The JAX smoke-config parameters of ``arch`` with the zero inits
    (norm scales) perturbed so every term counts; (cfg, numpy tree)."""
    cfg = port_config(jconfigs.smoke_config(arch))
    rng = np.random.default_rng(len(arch))

    def perturb(path, a):
        a = np.array(a)
        if path[-1].key in PERTURB:
            a = rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return cfg, jax.tree_util.tree_map_with_path(
        perturb, JM.init_params(cfg, jax.random.key(0)))


def family_cfg(arch, path="plain", **kw):
    cfg, tree = family_weights(arch)
    return dataclasses.replace(cfg, attention_impl=PATHS[path], **kw), tree


def jax_params(tree):
    return jax.tree.map(jnp.asarray, tree)


def batches(cfg, kind, seed, s=S):
    """(JAX batch, port batch) from both packages' ``make_batch``."""
    jb = JI.make_batch(cfg, JShape(kind, s, B, kind), seed=seed)
    pb = PI.make_batch(cfg, ShapeConfig(kind, s, B, kind), seed=seed,
                       device="cpu")
    return jb, pb


def offset_of(cfg):
    return cfg.n_img_tokens if cfg.frontend == "vision" else 0


def close_caches(got, want_tree, tol):
    """The port's per-layer caches against the JAX ones (pattern "A":
    one slot stacked over the layers)."""
    want = want_tree["groups"]["slot0"]
    assert len(got) == want.k.shape[0]
    for li, c in enumerate(got):
        for name, g, w in zip(c._fields, c, want):
            if name == "index":
                assert g == int(np.asarray(w)[li]), (li, name)
            elif name == "pos":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w)[li])
            else:
                close(g, np.asarray(w)[li], tol)


def close_grads(cfg, got, want_np):
    want = params_from_jax(cfg, want_np, device="cpu")
    g_leaves, w_leaves = tree_leaves(got), tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale)


def loss_and_grads(cfg, tree, nb):
    """(JAX loss, JAX grads, port loss, port grads) on one batch."""
    jl, jg = jax.value_and_grad(JM.loss_fn)(jax_params(tree), nb, cfg)
    params = params_from_jax(cfg, tree, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = PM.loss_fn(params, {k: torch.from_numpy(np.array(v))
                               for k, v in nb.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return jl, jax.tree.map(np.asarray, jg), loss.detach(), \
        tree_unflatten(params, list(grads))


# ---------------------------------------------------------------------------
# parameters and inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_family_init_matches_jax_layout(arch):
    """Same names and shapes as the JAX tree unstacked (encoder layers
    too), same count."""
    cfg, tree = family_weights(arch)
    mine = PM.init_params(cfg, torch.Generator().manual_seed(0))
    carried = params_from_jax(cfg, tree)

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        if isinstance(node, list):
            return [shapes(v) for v in node]
        return tuple(node.shape)

    assert shapes(mine) == shapes(carried)
    assert len(mine["layers"]) == cfg.n_layers
    assert len(mine.get("encoder", {}).get("layers", [])) == \
        cfg.encoder_layers
    assert ("img_proj" in mine) == (cfg.frontend == "vision")
    assert sum(t.numel() for t in tree_leaves(mine)) == \
        sum(a.size for a in jax.tree.leaves(tree))


def test_params_from_jax_unstacks_encoder_and_experts():
    """whisper's encoder layer i is the JAX stack's row i; granite's
    expert tensors keep their (E, D, F) / (E, F, D) layout."""
    cfg, tree = family_weights("whisper-large-v3")
    p = params_from_jax(cfg, tree)
    for i in range(cfg.encoder_layers):
        np.testing.assert_array_equal(
            p["encoder"]["layers"][i]["attn"]["wq"].numpy(),
            tree["encoder"]["layers"]["attn"]["wq"][i])
    np.testing.assert_array_equal(p["encoder"]["final_norm"].numpy(),
                                  tree["encoder"]["final_norm"])
    np.testing.assert_array_equal(p["layers"][1]["cross"]["wk"].numpy(),
                                  tree["groups"]["slot0"]["cross"]["wk"][1])
    cfg, tree = family_weights("granite-moe-3b-a800m")
    mlp = params_from_jax(cfg, tree)["layers"][1]["mlp"]
    m = cfg.moe
    assert mlp["router"].shape == (cfg.d_model, m.n_experts)
    assert mlp["w_gate"].shape == (m.n_experts, cfg.d_model, m.d_expert)
    assert mlp["w_down"].shape == (m.n_experts, m.d_expert, cfg.d_model)
    np.testing.assert_array_equal(mlp["w_up"].numpy(),
                                  tree["groups"]["slot0"]["mlp"]["w_up"][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_tensor_count(arch):
    """The full config's parameter tree on ``meta`` holds the JAX
    package's tensor count, which ``n_params()`` does not give for these
    families."""
    cfg = pconfigs.get_config(arch)
    got = sum(t.numel() for t in tree_leaves(PM.abstract_params(cfg)))
    assert all(t.device.type == "meta"
               for t in tree_leaves(PM.abstract_params(cfg)))
    assert got == FULL_COUNTS[arch]
    assert got == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        JM.abstract_params(jconfigs.get_config(arch))))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_matches_jax(arch, kind):
    """Equal batches from one seed; the port's specs have the JAX specs'
    names, shapes and dtypes, on ``meta``."""
    cfg = pconfigs.smoke_config(arch)
    js = JI.input_specs(cfg, JShape(kind, S, B, kind))
    ps = PI.input_specs(cfg, ShapeConfig(kind, S, B, kind))
    assert list(ps) == list(js)
    for k in js:
        assert tuple(ps[k].shape) == js[k].shape
        assert str(ps[k].dtype).replace("torch.", "") == str(js[k].dtype)
        assert ps[k].device.type == "meta"
    jb, pb = batches(cfg, kind, seed=5)
    for k in jb:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_and_skip_match(arch):
    cfg = pconfigs.smoke_config(arch)
    shape = ShapeConfig("decode", S, B, "decode")
    mine = PI.cache_specs(cfg, shape)
    want = JI.cache_specs(cfg, JShape("decode", S, B, "decode"))
    w = want["groups"]["slot0"]
    assert len(mine) == cfg.n_layers
    for c in mine:
        assert tuple(c.k.shape) == w.k.shape[1:]
        assert tuple(c.pos.shape) == w.pos.shape[1:]
        assert c.k.device.type == "meta"
    long_ = ShapeConfig("long_500k", 524288, 1, "decode")
    assert PI.check_applicable(cfg, long_) == JI.check_applicable(
        cfg, JShape("long_500k", 524288, 1, "decode"))
    with pytest.raises(PI.SkipCell):
        PI.input_specs(cfg, long_)


# ---------------------------------------------------------------------------
# layers and blocks
# ---------------------------------------------------------------------------

def test_gelu_mlp_matches():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 5, 16)).astype(np.float32)
    w_in = rng.normal(0, 0.3, (16, 32)).astype(np.float32)
    b_in = rng.normal(0, 0.1, 32).astype(np.float32)
    w_out = rng.normal(0, 0.3, (32, 16)).astype(np.float32)
    b_out = rng.normal(0, 0.1, 16).astype(np.float32)
    args = (x, w_in, b_in, w_out, b_out)
    got = PL.gelu_mlp(*map(torch.from_numpy, args))
    close(got, JL.gelu_mlp(*map(jnp.asarray, args)), LIKE_TOL)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 16), t=st.integers(1, 24),
       e=st.integers(2, 6), k=st.integers(1, 2), capacity=st.integers(1, 9))
def test_token_choice_dispatch_matches_jax(seed, t, e, k, capacity):
    """Slots, kept pairs and gates equal the JAX package's per-sequence
    dispatch on the same probabilities, drops included."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(e), size=(3, t)).astype(np.float32)
    slot, keep, gate = PB._token_choice_dispatch(torch.from_numpy(probs),
                                                 k, capacity)
    js, jk, jg = jax.vmap(lambda p: JB._token_choice_dispatch(
        p, k, capacity))(jnp.asarray(probs))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(js))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    close(gate, jg, dict(rtol=1e-6, atol=1e-7))


@pytest.mark.parametrize("router,factor", [("token_choice", 0.5),
                                           ("token_choice", 4.0),
                                           ("expert_choice", 1.0)])
def test_apply_moe_matches_jax(router, factor):
    """One MoE block, layer 1's weights, at a capacity that drops pairs
    (0.5), one that drops none (the smoke config's 4.0) and the
    expert-choice router."""
    cfg, tree = family_weights("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router=router, capacity_factor=factor))
    x = np.random.default_rng(4).normal(0, 1, (3, 24, cfg.d_model)
                                        ).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]),
                      tree["groups"]["slot0"]["mlp"])
    pp = params_from_jax(cfg, tree)["layers"][1]["mlp"]
    close(PB.apply_moe(pp, torch.from_numpy(x), cfg),
          JB.apply_moe(jp, jnp.asarray(x), cfg), LIKE_TOL)


def test_expert_choice_loss_and_grads_match():
    """granite with ``router="expert_choice"`` (capacity factor 1: C =
    16 of S = 32 tokens an expert; the smoke config's 4.0 would ask
    each expert for more tokens than the sequence has)."""
    cfg, tree = family_weights("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router="expert_choice", capacity_factor=1.0))
    jb, _ = batches(cfg, "train", seed=8)
    jl, jg, loss, grads = loss_and_grads(cfg, tree, jb)
    close(loss, jl, LIKE_TOL)
    close_grads(cfg, grads, jg)


def test_encode_matches_jax():
    cfg, tree = family_weights("whisper-large-v3")
    jb, pb = batches(cfg, "prefill", seed=6)
    got = PM._encode(params_from_jax(cfg, tree), pb["frames"], cfg)
    close(got, JM._encode(jax_params(tree), jb["frames"], cfg), LIKE_TOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_family_prefill_and_decode_match(arch, path):
    """prefill logits and caches, then three decode steps (whisper's with
    a random encoder output), against the JAX package on the same
    weights and batch."""
    cfg, tree = family_cfg(arch, path)
    jb, pb = batches(cfg, "prefill", seed=21)
    s_max = S + offset_of(cfg) + 8
    jp, pp = jax_params(tree), params_from_jax(cfg, tree)
    jl, jc = JM.prefill(jp, jb, cfg, s_max=s_max)
    pl_, pc = PM.prefill(pp, pb, cfg, s_max=s_max)
    assert pl_.shape == (B, 1, cfg.padded_vocab)
    close(pl_, jl, LIKE_TOL)
    close_caches(pc, jc, LIKE_TOL)
    rng = np.random.default_rng(22)
    toks = rng.integers(0, cfg.vocab, (B, 3)).astype(np.int32)
    enc = rng.normal(0, 1, (B, cfg.encoder_seq, cfg.d_model)
                     ).astype(np.float32)
    for step in range(3):
        pos = np.full((B, 1), S + offset_of(cfg) + step, np.int32)
        nb = {"tokens": toks[:, step:step + 1], "positions": pos}
        if cfg.is_encdec:
            nb["enc_out"] = enc
        jl, jc = JM.decode_step(jp, jc, jax.tree.map(jnp.asarray, nb), cfg)
        pl_, pc = PM.decode_step(pp, pc, {k: torch.from_numpy(v)
                                          for k, v in nb.items()}, cfg)
        close(pl_, jl, LIKE_TOL)
        close_caches(pc, jc, LIKE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_decode_matches_teacher_forcing(arch):
    """The JAX package's recipe: prefill(S) then decode(token S) equals
    forward(S+1) at S; vision positions continue after the image prefix,
    whisper's decode takes the encoder output of the same frames."""
    cfg, tree = family_cfg(arch)
    params = params_from_jax(cfg, tree)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1))
                            .astype(np.int32))
    pb, fb = {"tokens": toks[:, :S]}, {"tokens": toks}
    if cfg.frontend == "vision":
        img = torch.from_numpy(rng.normal(0, 1, (
            B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
        pb["img_embeds"] = fb["img_embeds"] = img
    frames = None
    if cfg.is_encdec:
        frames = torch.from_numpy(rng.normal(0, 1, (
            B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        pb["frames"] = fb["frames"] = frames
    x, _ = PM.forward(params, fb, cfg, mode="train")
    full = PM.logits_from_hidden(params, x[:, S:S + 1], cfg)
    offset = offset_of(cfg)
    _, caches = PM.prefill(params, pb, cfg, s_max=S + offset + 4)
    db = {"tokens": toks[:, S:S + 1],
          "positions": torch.full((B, 1), S + offset, dtype=torch.int32)}
    if cfg.is_encdec:
        db["enc_out"] = PM._encode(params, frames, cfg)
    dec, _ = PM.decode_step(params, caches, db, cfg)
    close(dec, full, TF_TOL)


# prompts whose padded length with BOS (and vision's 8 image tokens) is
# 32, a multiple of the smoke attention chunk, so the kernel path
# prefills through flash_attention
PROMPTS = {False: ["ip.src|10.0.0.1 tcp.dstport|666", "C2 beacon"],
           True: ["ip.src|10.0.0.1 tcp.dst", "C2 beacon"]}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_family_generate_matches_jax(arch, path):
    """Greedy generation through both packages' ``generate`` (zero
    image prefix and frames, zero encoder output in decode) gives the
    same tokens."""
    cfg, tree = family_cfg(arch, path)
    prompts = PROMPTS[cfg.frontend == "vision"]
    assert max(len(p) for p in prompts) + 1 + offset_of(cfg) == 32
    want = jserve.generate(cfg, jax_params(tree), prompts, max_new=10,
                           s_max=48)
    got = pserve.generate(cfg, params_from_jax(cfg, tree), prompts,
                          max_new=10, s_max=48)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_family_loss_and_grads_match(arch):
    """loss_fn and its gradients (MoE through the gather, scatter and
    index_add; whisper's encoder under remat; phi's img_proj)."""
    cfg, tree = family_cfg(arch)
    assert cfg.remat == "block"
    jb, _ = batches(cfg, "train", seed=3)
    jl, jg, loss, grads = loss_and_grads(cfg, tree, jb)
    close(loss, jl, LIKE_TOL)
    close_grads(cfg, grads, jg)
    if "img_proj" in grads:
        assert float(grads["img_proj"].abs().max()) > 0


@pytest.mark.parametrize("arch,head_pad,kv_pad",
                         [("whisper-large-v3", 8, 8),
                          ("granite-moe-3b-a800m", 8, 0)])
def test_head_padding_exact(arch, head_pad, kv_pad):
    """A padded-head model computes exactly the logical model: the
    logical weights grafted into the first heads of the padded tree
    (zeros elsewhere) give the same loss (the JAX package's test, with
    granite's GQA beside whisper's MHA)."""
    cfg0 = pconfigs.smoke_config(arch)
    cfgP = dataclasses.replace(cfg0, head_pad=head_pad, kv_pad=kv_pad)
    p0 = PM.init_params(cfg0, torch.Generator().manual_seed(0))
    pP = PM.init_params(cfgP, torch.Generator().manual_seed(0))

    def graft(a, b):
        if isinstance(b, list):
            return [graft(x, y) for x, y in zip(a, b)]
        out = {}
        for key in b:
            if isinstance(b[key], (dict, list)):
                out[key] = graft(a[key], b[key])
            elif key in ("wq", "wk", "wv", "bq", "bk", "bv"):
                n = a[key].shape[-1]
                out[key] = torch.zeros_like(b[key])
                out[key][..., :n] = a[key]
            elif key == "wo" and b[key].shape != a[key].shape:
                n = a[key].shape[-2]
                out[key] = torch.zeros_like(b[key])
                out[key][..., :n, :] = a[key]
            else:
                out[key] = a[key]
        return out

    pP = graft(p0, pP)
    _, pb = batches(cfg0, "train", seed=0)
    l0 = PM.loss_fn(p0, pb, cfg0)
    lP = PM.loss_fn(pP, pb, cfgP)
    assert abs(float(l0) - float(lP)) < 1e-4


def test_family_kernel_launch_routing(monkeypatch):
    """On the kernel path every arch's prefill reaches flash_attention
    once a decoder layer (whisper's cross-attention over 24 frames, not
    a multiple of the 16-key block, and its encoder, naive, never);
    with head padding (a head→kv map, as whisper's and granite's full
    configs have) never; decode never."""
    calls = []
    real = PL.flash_attention

    def flash(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(PL, "flash_attention", flash)
    for arch in ARCHS:
        for pad in (0, 8):
            cfg, _ = family_cfg(arch, "kernels", head_pad=pad)
            params = PM.init_params(cfg, torch.Generator().manual_seed(0))
            _, pb = batches(cfg, "prefill", seed=1, s=S - offset_of(cfg))
            calls.clear()
            _, caches = PM.prefill(params, pb, cfg, s_max=64)
            assert len(calls) == (0 if pad else cfg.n_layers), (arch, pad)
            calls.clear()
            db = {"tokens": pb["tokens"][:, :1],
                  "positions": torch.full((B, 1), 50, dtype=torch.int32)}
            if cfg.is_encdec:
                db["enc_out"] = pb["frames"]
            PM.decode_step(params, caches, db, cfg)
            assert not calls, arch


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_has_no_drops_at_smoke_capacity(arch):
    """The smoke configs' capacity factor 4.0 keeps every (token,
    choice) pair at S = 32 (C = 64 > S, so no expert can overflow) and
    teacher forcing holds; layer 0's router weights over the embedded
    tokens give the JAX package's top-k expert ids."""
    cfg, tree = family_cfg(arch)
    _, pb = batches(cfg, "prefill", seed=2)
    p = params_from_jax(cfg, tree)
    x, _, _, _, _ = PM._embed_inputs(p, pb, cfg, "prefill")
    mlp = p["layers"][0]["mlp"]
    h = PL.rms_norm(x, mlp["ln"], cfg.norm_eps)
    probs = torch.softmax(h @ mlp["router"], dim=-1)
    C = PB.moe_capacity(cfg.moe, S)
    assert C == 64
    slot, keep, _ = PB._token_choice_dispatch(probs, cfg.moe.top_k, C)
    assert bool(keep.all())
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.moe.top_k)
    np.testing.assert_array_equal(
        (slot // C).numpy(), np.asarray(want).reshape(B, -1))
