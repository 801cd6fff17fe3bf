"""The port's RWKV-6 serving path against the JAX package's, at the smoke
config in float32, on the same weights (the JAX tree carried across by
``params_from_jax``) and the same numpy inputs.

The JAX package's ``rwkv_impl="pallas"`` runs its Pallas kernel in
interpret mode; the port's runs the ``wkv6`` wrapper, which on CPU
tensors is the plain sequential recurrence.

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


@pytest.mark.parametrize("arch", [a for a in jconfigs.ARCHS
                                  if a != "rwkv6_1_6b"])
def test_other_families_raise(arch):
    cfg = pconfigs.smoke_config(arch)
    with pytest.raises(NotImplementedError):
        PM.init_params(cfg, torch.Generator().manual_seed(0))


def test_unrolled_impl_raises(weights):
    cfg, tree = weights
    cfg = with_impl(cfg, "unrolled")
    toks = torch.from_numpy(tokens(cfg, 1, 8, seed=2))
    with pytest.raises(NotImplementedError):
        PM.prefill(params_from_jax(cfg, tree), {"tokens": toks}, cfg, 16)


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
             ("chunked", 4 * chunk, 0), ("scan", 4 * chunk, 0)]
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
