"""The port's serving path against the JAX package's, at the smoke
configs in float32, on the same weights (the JAX tree carried across by
``params_from_jax``) and the same numpy inputs: RWKV-6, and the
recurrentgemma hybrid (RG-LRU + local attention) with the dense
attention families (the MoE, encoder-decoder and vision families are in
``tests/test_torch_families.py``).

The JAX package's ``*_impl="pallas"`` runs its Pallas kernels in
interpret mode; the port's runs the ``wkv6``, ``rglru_scan`` and
``flash_attention`` wrappers, which on CPU tensors are the plain
versions.

Tolerances, with their reasons:
* ``LIKE_TOL`` rtol=atol=1e-4 — the same WKV form in both packages,
  float32 matmuls summed in another order, through a few layers;
* ``FORMS_TOL`` rtol=atol=1e-3 — the JAX Pallas kernel (chunked
  factorization) against the port's sequential recurrence: the JAX
  package's own tolerance between the two forms (tests/test_kernels.py);
* ``TF_TOL`` rtol=atol=1e-4 — decode after prefill against a teacher-
  forced forward in the port (the JAX package's test_models.py checks
  the same property at 2e-2 for every family).
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import tokenizer as jtok
from repro.launch import serve as jserve
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import configs as pconfigs
from repro_torch.data import tokenizer as ptok
from repro_torch.device import set_device
from repro_torch.launch import serve as pserve
from repro_torch.models import blocks as PB
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import params_from_jax

LIKE_TOL = dict(rtol=1e-4, atol=1e-4)
FORMS_TOL = dict(rtol=1e-3, atol=1e-3)
TF_TOL = dict(rtol=1e-4, atol=1e-4)
IMPLS = ("scan", "chunked", "pallas")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def tol_for(impl):
    return FORMS_TOL if impl == "pallas" else LIKE_TOL


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def weights():
    """The JAX smoke-config parameters, with the zero/constant inits
    (norm scales, lerps, bonus, decay bias) perturbed so every term
    counts; returned as (cfg, numpy tree)."""
    cfg = jconfigs.smoke_config("rwkv6-1.6b")
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    lay = tree["groups"]["slot0"]["rwkv"]
    for name in ("ln1", "ln2", "ln_x", "u"):
        lay[name] = rng.normal(0, 0.1, lay[name].shape).astype(np.float32)
    for name in ("mu", "mu_c"):
        lay[name] = rng.uniform(0, 1, lay[name].shape).astype(np.float32)
    lay["dw_bias"] = rng.uniform(-3, -0.5, lay["dw_bias"].shape).astype(
        np.float32)
    tree["final_norm"] = rng.normal(0, 0.1, tree["final_norm"].shape
                                    ).astype(np.float32)
    return cfg, tree


def jax_params(tree):
    return jax.tree.map(jnp.asarray, tree)


def with_impl(cfg, impl):
    return dataclasses.replace(cfg, rwkv_impl=impl)


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def close_caches(got, want_tree, tol):
    """The port's per-layer caches against the JAX stacked ones."""
    want = want_tree["groups"]["slot0"]
    assert len(got) == want.wkv.shape[0]
    for li, c in enumerate(got):
        close(c.wkv, want.wkv[li], tol)
        close(c.shift1, want.shift1[li], tol)
        close(c.shift2, want.shift2[li], tol)


# ---------------------------------------------------------------------------
# configs, tokenizer, layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match(arch):
    for name in (arch, arch.replace("_", "-")):
        assert pconfigs.canonical(name) == jconfigs.canonical(name)
    p, j = pconfigs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.n_params() == j.n_params()
    assert p.layer_types() == j.layer_types()
    assert p.padded_vocab == j.padded_vocab
    assert dataclasses.asdict(pconfigs.smoke_config(arch)) == \
        dataclasses.asdict(jconfigs.smoke_config(arch))


def test_aliases_match():
    assert pconfigs.ARCHS == jconfigs.ARCHS
    assert pconfigs._ALIASES == jconfigs._ALIASES


@pytest.mark.parametrize("text", ["", "ip.src|1.1.1.1\tx", "héllo ✓"])
def test_tokenizer_matches(text):
    for kw in ({}, {"add_bos": False, "add_eos": True}):
        a, b = ptok.encode(text, **kw), jtok.encode(text, **kw)
        np.testing.assert_array_equal(a, b)
        assert ptok.decode(a) == jtok.decode(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 5, 64)).astype(np.float32)
    s = rng.normal(0, 0.1, 64).astype(np.float32)
    got = PL.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(s).to(getattr(torch, dtype)))
    want = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(s, dtype))
    tol = LIKE_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    close(got.float(), np.asarray(want, np.float32), tol)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_init_params_match_jax_layout(weights):
    """Same names and shapes as the JAX tree unstacked, same count."""
    cfg, tree = weights
    mine = PM.init_params(cfg, torch.Generator().manual_seed(0))
    carried = params_from_jax(cfg, tree)

    def shapes(p):
        top = {k: v.shape for k, v in p.items() if k != "layers"}
        return top, [{k: v.shape for k, v in lay["rwkv"].items()}
                     for lay in p["layers"]]

    assert shapes(mine) == shapes(carried)
    assert len(mine["layers"]) == cfg.n_layers
    n = sum(v.numel() for k, v in mine.items() if k != "layers") + sum(
        v.numel() for lay in mine["layers"] for v in lay["rwkv"].values())
    assert n == sum(a.size for a in jax.tree.leaves(tree))


def test_init_params_seeded(weights):
    cfg, _ = weights
    a = PM.init_params(cfg, torch.Generator().manual_seed(3))
    b = PM.init_params(cfg, torch.Generator().manual_seed(3))
    assert torch.equal(a["layers"][1]["rwkv"]["wk"],
                       b["layers"][1]["rwkv"]["wk"])


def test_params_from_jax_unstacks_layers(weights):
    cfg, tree = weights
    p = params_from_jax(cfg, tree)
    for li in range(cfg.n_layers):
        np.testing.assert_array_equal(
            p["layers"][li]["rwkv"]["wr"].numpy(),
            tree["groups"]["slot0"]["rwkv"]["wr"][li])
    np.testing.assert_array_equal(p["head"].numpy(), tree["head"])


# the families the port added last (tests/test_torch_families.py)
OTHER = ("whisper_large_v3", "granite_moe_3b_a800m", "qwen3_moe_235b_a22b",
         "phi_3_vision_4_2b")


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise(arch):
    """The MoE, encoder-decoder and vision families build; only an
    unknown block type raises."""
    cfg = pconfigs.smoke_config(arch)
    PM.check_supported(cfg)
    params = PM.init_params(cfg, torch.Generator().manual_seed(0))
    assert len(params["layers"]) == cfg.n_layers
    with pytest.raises(NotImplementedError):
        PM.init_params(dataclasses.replace(cfg, pattern="X"),
                       torch.Generator().manual_seed(0))


def test_unrolled_impl_raises(weights):
    """``rwkv_impl="unrolled"`` raises nothing: its prefill (the JAX
    package's Python-loop WKV, the port's ``wkv_scan``) and a decode
    step after it (``wkv_scan`` in both) equal the JAX package's, and an
    unknown impl still raises."""
    cfg, tree = weights
    cfg = with_impl(cfg, "unrolled")
    B, S = 2, 12
    toks = tokens(cfg, B, S + 1, seed=2)
    jp, pp = jax_params(tree), params_from_jax(cfg, tree)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, cfg,
                        s_max=S + 4)
    pl_, pc = PM.prefill(pp, {"tokens": torch.from_numpy(toks[:, :S])}, cfg,
                         s_max=S + 4)
    close(pl_, jl, LIKE_TOL)
    close_caches(pc, jc, LIKE_TOL)
    pos = np.full((B, 1), S, np.int32)
    jl, jc = JM.decode_step(jp, jc, {"tokens": jnp.asarray(toks[:, S:]),
                                     "positions": jnp.asarray(pos)}, cfg)
    pl_, pc = PM.decode_step(pp, pc, {"tokens": torch.from_numpy(toks[:, S:]),
                                      "positions": torch.from_numpy(pos)},
                             cfg)
    close(pl_, jl, LIKE_TOL)
    close_caches(pc, jc, LIKE_TOL)
    with pytest.raises(NotImplementedError):
        PM.prefill(pp, {"tokens": torch.from_numpy(toks[:, :S])},
                   with_impl(cfg, "loop"), S + 4)


# ---------------------------------------------------------------------------
# the RWKV block
# ---------------------------------------------------------------------------

def block_inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    cache = (rng.normal(0, 1, (B, H, Dh, Dh)).astype(np.float32),
             rng.normal(0, 1, (B, cfg.d_model)).astype(np.float32),
             rng.normal(0, 1, (B, cfg.d_model)).astype(np.float32))
    return x, cache


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode,S", [("prefill", 32), ("prefill", 12),
                                    ("decode", 1)])
def test_apply_rwkv_matches(weights, impl, mode, S):
    """One block, layer 1's weights; decode starts from a random cache."""
    cfg, tree = weights
    cfg = with_impl(cfg, impl)
    x, cache = block_inputs(cfg, 2, S, seed=S)
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]),
                      tree["groups"]["slot0"]["rwkv"])
    pp = params_from_jax(cfg, tree)["layers"][1]["rwkv"]
    pos = np.zeros((2, S), np.int32)
    jcache = JB.RWKVCache(*map(jnp.asarray, cache))
    pcache = PB.RWKVCache(*map(torch.from_numpy, cache))
    jy, jc = JB.apply_rwkv(jp, jnp.asarray(x), JB.Ctx(jnp.asarray(pos), mode,
                                                     jcache), cfg)
    py, pc = PB.apply_rwkv(pp, torch.from_numpy(x),
                           PB.Ctx(torch.from_numpy(pos), mode, pcache), cfg)
    close(py, jy, tol_for(impl))
    for g, w in zip(pc, jc):
        close(g, w, tol_for(impl))


def test_kernel_branch_order(weights, monkeypatch):
    """The wkv6 wrapper is reached exactly where the JAX package reaches
    its Pallas kernel: prefill with S a multiple of rwkv_chunk (≥ it)."""
    cfg, tree = weights
    calls = []
    real = PB.wkv6

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(PB, "wkv6", spy)
    params = params_from_jax(cfg, tree)
    chunk = cfg.rwkv_chunk
    cases = [("pallas", 4 * chunk, cfg.n_layers), ("pallas", chunk,
                                                   cfg.n_layers),
             ("pallas", 3 * chunk + 1, 0), ("pallas", chunk - 1, 0),
             ("chunked", 4 * chunk, 0), ("scan", 4 * chunk, 0),
             ("unrolled", 4 * chunk, 0)]
    for impl, S, want in cases:
        c = with_impl(cfg, impl)
        calls.clear()
        toks = torch.from_numpy(tokens(c, 2, S, seed=S))
        _, caches = PM.prefill(params, {"tokens": toks}, c, s_max=S + 4)
        assert len(calls) == want, (impl, S)
        calls.clear()
        PM.decode_step(params, caches, {"tokens": toks[:, :1]}, c)
        assert not calls, "decode reached the kernel"


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match(weights, impl):
    """prefill logits and caches, then two decode steps, against the JAX
    package on the same weights and tokens."""
    cfg, tree = weights
    cfg = with_impl(cfg, impl)
    B, S = 2, 32
    toks = tokens(cfg, B, S + 2, seed=11)
    jp, pp = jax_params(tree), params_from_jax(cfg, tree)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, cfg,
                        s_max=S + 4)
    pl_, pc = PM.prefill(pp, {"tokens": torch.from_numpy(toks[:, :S])}, cfg,
                         s_max=S + 4)
    assert pl_.shape == (B, 1, cfg.padded_vocab)
    assert pl_.dtype == torch.float32
    close(pl_, jl, tol_for(impl))
    close_caches(pc, jc, tol_for(impl))
    for step in range(2):
        tok = toks[:, S + step:S + step + 1]
        pos = np.full((B, 1), S + step, np.int32)
        jl, jc = JM.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                         "positions": jnp.asarray(pos)}, cfg)
        pl_, pc = PM.decode_step(pp, pc, {"tokens": torch.from_numpy(tok),
                                          "positions": torch.from_numpy(pos)},
                                 cfg)
        close(pl_, jl, tol_for(impl))
        close_caches(pc, jc, tol_for(impl))


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_matches_teacher_forcing(weights, impl):
    """prefill(S) then decode(token S) equals forward(S+1) at S."""
    cfg, tree = weights
    cfg = with_impl(cfg, impl)
    S = 32
    toks = torch.from_numpy(tokens(cfg, 2, S + 1, seed=12))
    params = params_from_jax(cfg, tree)
    x, _ = PM.forward(params, {"tokens": toks}, cfg, mode="train")
    full = PM.logits_from_hidden(params, x[:, S:S + 1], cfg)
    _, caches = PM.prefill(params, {"tokens": toks[:, :S]}, cfg, s_max=S + 4)
    dec, _ = PM.decode_step(params, caches, {
        "tokens": toks[:, S:S + 1],
        "positions": torch.full((2, 1), S, dtype=torch.int32)}, cfg)
    close(dec, full, TF_TOL)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_generate_matches_jax(weights, impl):
    """Greedy generation gives the JAX package's tokens; the prompts'
    padded length (with BOS) is a multiple of rwkv_chunk, so the pallas
    config prefills through the kernel."""
    cfg, tree = weights
    cfg = with_impl(cfg, impl)
    prompts = ["ip.src|10.0.0.1 tcp.dstport|666", "C2 beacon"]
    assert (max(len(p) for p in prompts) + 1) % cfg.rwkv_chunk == 0
    want = jserve.generate(cfg, jax_params(tree), prompts, max_new=12,
                           s_max=64)
    got = pserve.generate(cfg, params_from_jax(cfg, tree), prompts,
                          max_new=12, s_max=64)
    assert got == want


def test_generate_temperature_is_seeded(weights):
    cfg, tree = weights
    params = params_from_jax(cfg, tree)
    run = lambda seed: pserve.generate(cfg, params, ["abc"], max_new=8,
                                       temperature=1.0, seed=seed)
    assert run(1) == run(1)
    assert run(1) != run(2)


def test_serve_main_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_DEVICE="cpu")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--max-new", "4", "--prompt", "ip.dst|"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "4 tokens in" in out.stdout and "on cpu" in out.stdout



# ---------------------------------------------------------------------------
# recurrentgemma and the dense attention families
# ---------------------------------------------------------------------------

FAMILIES = ("recurrentgemma-9b", "h2o-danube-1.8b", "phi3-mini-3.8b",
            "internlm2-20b", "qwen2.5-14b")
# (rglru_impl, attention_impl): the plain path and the kernel path
PATHS = {"plain": ("scan", "chunked"), "kernels": ("pallas", "pallas")}
PERTURB = ("ln", "final_norm", "conv_b", "bq", "bk", "bv")


def test_supported_families():
    """Every config of the registry is supported, smoke and full; a
    block type the port has no block for raises."""
    for arch in jconfigs.ARCHS:
        PM.check_supported(pconfigs.smoke_config(arch))
        PM.check_supported(pconfigs.get_config(arch))
        with pytest.raises(NotImplementedError):
            PM.check_supported(dataclasses.replace(
                pconfigs.smoke_config(arch), pattern="AX"))


@functools.cache
def family_weights(arch):
    """The JAX smoke-config parameters of ``arch`` with the zero inits
    (norm scales, conv bias, qkv biases) perturbed so every term counts;
    (cfg, numpy tree), made once per arch."""
    cfg = jconfigs.smoke_config(arch)
    rng = np.random.default_rng(len(arch))

    def perturb(path, a):
        a = np.array(a)
        if path[-1].key in PERTURB:
            a = rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return cfg, jax.tree_util.tree_map_with_path(
        perturb, JM.init_params(cfg, jax.random.key(0)))


def family_cfg(arch, path):
    cfg, tree = family_weights(arch)
    rglru_impl, attention_impl = PATHS[path]
    return dataclasses.replace(cfg, rglru_impl=rglru_impl,
                               attention_impl=attention_impl), tree


def close_family_caches(cfg, got, want_tree, tol):
    """The port's per-layer caches against the JAX ones, stacked by
    period slot (``groups/slot<i>``) with the remainder in ``tail``."""
    period = len(cfg.pattern)
    n_grouped = cfg.n_layers // period * period
    assert len(got) == cfg.n_layers
    for li, c in enumerate(got):
        if li < n_grouped:
            g, slot = divmod(li, period)
            want = jax.tree.map(lambda a, g=g: np.asarray(a)[g],
                                want_tree["groups"][f"slot{slot}"])
        else:
            want = want_tree["tail"][f"layer{li - n_grouped}"]
        assert type(c).__name__ == type(want).__name__
        for name, g_, w_ in zip(c._fields, c, want):
            if name == "index":
                assert g_ == int(w_), (li, name)
            elif name == "pos":
                np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
            else:
                close(g_, w_, tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_matches_jax_layout(arch):
    """Same names and shapes as the JAX tree unstacked, same count."""
    cfg, tree = family_weights(arch)
    mine = PM.init_params(cfg, torch.Generator().manual_seed(0))
    carried = params_from_jax(cfg, tree)

    def shapes(p):
        return ({k: v.shape for k, v in p.items() if k != "layers"},
                [{blk: {n: a.shape for n, a in sub.items()}
                  for blk, sub in lay.items()} for lay in p["layers"]])

    assert shapes(mine) == shapes(carried)
    n = sum(v.numel() for k, v in mine.items() if k != "layers") + sum(
        a.numel() for lay in mine["layers"] for sub in lay.values()
        for a in sub.values())
    assert n == sum(a.size for a in jax.tree.leaves(tree))


def test_params_from_jax_unstacks_the_hybrid_period():
    """recurrentgemma's RRL period stacked over 2 groups plus an R tail:
    layer li comes from group li // 3, slot li % 3, then tail/layer0."""
    cfg, tree = family_weights("recurrentgemma-9b")
    assert cfg.layer_types() == tuple("RRLRRLR")
    p = params_from_jax(cfg, tree)
    for li, lt in enumerate(cfg.layer_types()):
        lay = p["layers"][li]
        assert set(lay) == ({"attn", "mlp"} if lt == "L" else
                            {"rglru", "mlp"})
        want = tree["tail"]["layer0"] if li == 6 else jax.tree.map(
            lambda a: a[li // 3], tree["groups"][f"slot{li % 3}"])
        for blk, sub in lay.items():
            for name, a in sub.items():
                np.testing.assert_array_equal(a.numpy(),
                                              np.asarray(want[blk][name]))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_and_decode_match(arch, path):
    """prefill logits and caches, then three decode steps (the local
    layers' 16-slot rings wrap), against the JAX package on the same
    weights and tokens."""
    cfg, tree = family_cfg(arch, path)
    B, S, s_max = 2, 32, 48
    toks = tokens(cfg, B, S + 3, seed=21)
    jp, pp = jax_params(tree), params_from_jax(cfg, tree)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, cfg,
                        s_max=s_max)
    pl_, pc = PM.prefill(pp, {"tokens": torch.from_numpy(toks[:, :S])}, cfg,
                         s_max=s_max)
    assert pl_.shape == (B, 1, cfg.padded_vocab)
    close(pl_, jl, LIKE_TOL)
    close_family_caches(cfg, pc, jc, LIKE_TOL)
    for step in range(3):
        tok = toks[:, S + step:S + step + 1]
        pos = np.full((B, 1), S + step, np.int32)
        jl, jc = JM.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                         "positions": jnp.asarray(pos)}, cfg)
        pl_, pc = PM.decode_step(pp, pc, {"tokens": torch.from_numpy(tok),
                                          "positions": torch.from_numpy(pos)},
                                 cfg)
        close(pl_, jl, LIKE_TOL)
        close_family_caches(cfg, pc, jc, LIKE_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_matches_teacher_forcing(arch):
    """prefill(S) then decode(token S) equals forward(S+1) at S, with the
    local layers' rings already wrapped."""
    cfg, tree = family_cfg(arch, "plain")
    S = 24
    toks = torch.from_numpy(tokens(cfg, 2, S + 1, seed=22))
    params = params_from_jax(cfg, tree)
    x, _ = PM.forward(params, {"tokens": toks}, cfg, mode="train")
    full = PM.logits_from_hidden(params, x[:, S:S + 1], cfg)
    _, caches = PM.prefill(params, {"tokens": toks[:, :S]}, cfg, s_max=40)
    dec, _ = PM.decode_step(params, caches, {
        "tokens": toks[:, S:S + 1],
        "positions": torch.full((2, 1), S, dtype=torch.int32)}, cfg)
    close(dec, full, TF_TOL)


def test_family_kernel_launch_routing(monkeypatch):
    """recurrentgemma's prefill reaches rglru_scan once per R layer and
    flash_attention once per L layer on the kernel path, neither on the
    plain path, and decode reaches neither."""
    calls = {"rglru_scan": 0, "flash_attention": 0}
    real_scan, real_flash = PB.rglru_scan, PL.flash_attention

    def scan(*a):
        calls["rglru_scan"] += 1
        return real_scan(*a)

    def flash(*a, **kw):
        calls["flash_attention"] += 1
        return real_flash(*a, **kw)

    monkeypatch.setattr(PB, "rglru_scan", scan)
    monkeypatch.setattr(PL, "flash_attention", flash)
    for path, want in [("kernels", (5, 2)), ("plain", (0, 0))]:
        cfg, tree = family_cfg("recurrentgemma-9b", path)
        params = params_from_jax(cfg, tree)
        toks = torch.from_numpy(tokens(cfg, 2, 32, seed=23))
        calls.update(rglru_scan=0, flash_attention=0)
        _, caches = PM.prefill(params, {"tokens": toks}, cfg, s_max=40)
        assert (calls["rglru_scan"], calls["flash_attention"]) == want, path
        PM.decode_step(params, caches, {
            "tokens": toks[:, :1],
            "positions": torch.full((2, 1), 32, dtype=torch.int32)}, cfg)
        assert (calls["rglru_scan"], calls["flash_attention"]) == want, path


@pytest.mark.parametrize("arch,path", [(a, "kernels") for a in FAMILIES]
                         + [("recurrentgemma-9b", "plain")])
def test_family_generate_matches_jax(arch, path):
    """Greedy generation gives the JAX package's tokens; the prompts'
    padded length with BOS is 32, a multiple of the smoke attention
    chunk, so the kernel path prefills through both kernels, and the
    local layers' 16-slot rings wrap in prefill and in decode."""
    cfg, tree = family_cfg(arch, path)
    prompts = ["ip.src|10.0.0.1 tcp.dstport|666", "C2 beacon"]
    assert max(len(p) for p in prompts) + 1 == 32
    want = jserve.generate(cfg, jax_params(tree), prompts, max_new=10,
                           s_max=48)
    got = pserve.generate(cfg, params_from_jax(cfg, tree), prompts,
                          max_new=10, s_max=48)
    assert got == want
