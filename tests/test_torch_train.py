"""The port's training path against the JAX package's, at the smoke
configs in float32, on the same weights (the JAX tree carried across by
``params_from_jax``) and the same numpy batches from a seed.

Tolerances, with their reasons:
* ``CE_TOL`` rtol=1e-6 — the cross-entropies, float32 logits summed in
  another order;
* ``LOSS_TOL`` rtol=1e-5 — the loss through a few layers (float32
  matmuls summed in another order);
* ``GRAD_TOL`` rtol=1e-4, atol=1e-4·max|g| of the leaf — gradients
  through the same layers backwards: relative errors of 1e-5 per layer
  compound, and entries near 0 have no relative accuracy;
* ``ADAM_TOL`` rtol=1e-6 — AdamW on given gradients, the same float32
  operations in the same order;
* parameters after two steps at lr=1e-3: Adam maps each gradient to
  about ±lr, so where a gradient entry is tiny against the root of its
  second moment the two packages' equal-within-``GRAD_TOL`` gradients can
  move it by up to 2·lr apart a step.  So every entry within
  ``2·lr·steps`` (the most two Adam updates can differ by), and at least
  ``STEP_PARAM_SHARE`` (99.9%) of all entries within ``STEP_PARAM_ATOL``
  2e-6 (measured: 2 of 16,384 entries of rwkv6's embedding beyond it,
  by 4.6e-6);
* remat, micro-batching and the kernels' forward-only guard: the port
  against itself, ``SELF_TOL`` rtol=atol=1e-6 (micro-batching sums
  another way; remat recomputes the same operations).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train import trainer as JT
from repro_torch import configs as pconfigs
from repro_torch.device import set_device
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import params_from_jax
from repro_torch.train import optimizer as PO
from repro_torch.train import trainer as PT
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

CE_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4          # atol x max|g| of the leaf
ADAM_TOL = dict(rtol=1e-6, atol=1e-9)
STEP_PARAM_ATOL, STEP_PARAM_SHARE = 2e-6, 0.999
SELF_TOL = dict(rtol=1e-6, atol=1e-6)
FAMILIES = ("rwkv6-1.6b", "recurrentgemma-9b", "h2o-danube-1.8b",
            "granite-moe-3b-a800m", "whisper-large-v3")
B, S = 4, 16


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


@functools.cache
def weights(arch):
    """The JAX smoke parameters of ``arch`` with every leaf perturbed
    (so the zero inits count); (cfg, numpy tree)."""
    cfg = jconfigs.smoke_config(arch)
    rng = np.random.default_rng(len(arch))
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.02, a.shape))
        .astype(np.float32), JM.init_params(cfg, jax.random.key(0)))
    return cfg, tree


def batch(cfg, seed=0, b=B, s=S):
    """Tokens and labels, and for an encoder-decoder config normal
    frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        out["frames"] = rng.normal(0, 1, (b, cfg.encoder_seq, cfg.d_model)
                                   ).astype(np.float32)
    return out


def pt(np_batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in np_batch.items()}


def jx(np_batch):
    return {k: jnp.asarray(v) for k, v in np_batch.items()}


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def close_grads(cfg, got, want_np, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    """Port gradients (the port's tree) against the JAX gradient tree,
    restacked through ``params_from_jax``, leaf by leaf."""
    want = params_from_jax(cfg, want_np, device="cpu")
    g_leaves, w_leaves = tree_leaves(got), tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.detach().float().numpy(), w,
                                   rtol=rtol, atol=atol * scale)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------

def test_cross_entropy_matches():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 8, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 8)).astype(np.int32)
    labels[0, :3] = -100
    close(PL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)),
          JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)), CE_TOL)
    # every label ignored: the mean over no tokens is 0
    none = np.full_like(labels, -100)
    assert float(PL.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("valid_vocab", [0, 30])
def test_chunked_cross_entropy_matches(valid_vocab):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 12, 16)).astype(np.float32)
    w = rng.normal(0, 0.5, (16, 32)).astype(np.float32)
    labels = rng.integers(0, valid_vocab or 32, (2, 12)).astype(np.int32)
    labels[1, 5] = -100
    got = PL.chunked_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(labels), 3,
                                   valid_vocab=valid_vocab)
    want = JL.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(labels), 3,
                                    valid_vocab=valid_vocab)
    close(got, want, CE_TOL)
    # the unchunked form on the same (masked) logits gives the same loss
    logits = torch.from_numpy(x) @ torch.from_numpy(w)
    if valid_vocab:
        logits[..., valid_vocab:] -= 1e9
    close(got, PL.cross_entropy(logits, torch.from_numpy(labels)), CE_TOL)
    with pytest.raises(ValueError):
        PL.chunked_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(labels), 5)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss_chunk", [0, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match(arch, loss_chunk):
    cfg, tree = weights(arch)
    cfg = dataclasses.replace(cfg, loss_chunk=loss_chunk)
    nb = batch(cfg, seed=3)
    jl, jg = jax.value_and_grad(JM.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jx(nb), cfg)
    params = params_from_jax(cfg, tree, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = PM.loss_fn(params, pt(nb), cfg)
    close(loss.detach(), jl, LOSS_TOL)
    grads = torch.autograd.grad(loss, leaves)
    close_grads(cfg, tree_unflatten(params, list(grads)),
                jax.tree.map(np.asarray, jg))


def test_unrolled_wkv_loss_and_grads_match():
    """``rwkv_impl="unrolled"`` in training: the JAX package's
    Python-loop WKV against the port's ``wkv_scan``, loss and gradients
    at the tolerances above."""
    cfg, tree = weights("rwkv6-1.6b")
    cfg = dataclasses.replace(cfg, rwkv_impl="unrolled")
    nb = batch(cfg, seed=4)
    jl, jg = jax.value_and_grad(JM.loss_fn)(
        jax.tree.map(jnp.asarray, tree), jx(nb), cfg)
    params = params_from_jax(cfg, tree, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = PM.loss_fn(params, pt(nb), cfg)
    close(loss.detach(), jl, LOSS_TOL)
    grads = torch.autograd.grad(loss, leaves)
    close_grads(cfg, tree_unflatten(params, list(grads)),
                jax.tree.map(np.asarray, jg))


def test_remat_block_equals_none():
    cfg, tree = weights("recurrentgemma-9b")
    nb = pt(batch(cfg, seed=4))
    out = {}
    for remat in ("none", "block"):
        c = dataclasses.replace(cfg, remat=remat)
        params = params_from_jax(c, tree, device="cpu")
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = PM.loss_fn(params, nb, c)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    close(out["block"][0], out["none"][0], SELF_TOL)
    for a, b in zip(out["block"][1], out["none"][1]):
        close(a, b, SELF_TOL)


def test_remat_recomputes_in_backward(monkeypatch):
    """With remat="block" each layer runs twice in a train step (forward
    and the backward's recomputation); with "none" once."""
    cfg, tree = weights("rwkv6-1.6b")
    calls = []
    real = PM._apply_layer

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(PM, "_apply_layer", counting)
    for remat, want in (("none", 1), ("block", 2)):
        calls.clear()
        c = dataclasses.replace(cfg, remat=remat)
        step = PT.make_train_step(c, PO.OptConfig())
        params, state = PT.init_train_state(c, torch.Generator()
                                            .manual_seed(0))
        step(params, state, pt(batch(c)))
        assert len(calls) == want * c.n_layers, (remat, len(calls))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_update_matches():
    rng = np.random.default_rng(5)
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 2, 2)}}
    params = jax.tree.map(lambda s: rng.normal(0, 1, s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    opt = JO.OptConfig(lr=1e-2, warmup_steps=3, grad_clip=1.0)
    popt = PO.OptConfig(lr=1e-2, warmup_steps=3, grad_clip=1.0)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = JO.adamw_init(jp)
    tp = tree_map(torch.from_numpy, params)
    ts = PO.adamw_init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: rng.normal(0, 0.5 + i, a.shape)
                         .astype(np.float32), params)
        jp, js, jn = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                     opt)
        tg = tree_map(torch.from_numpy, g)
        before = [t.clone() for t in tree_leaves(tg)]
        tp2, ts2, tn = PO.adamw_update(tp, tg, ts, popt)
        # parameters and moments updated in place (donated), the
        # gradients left as they were
        assert all(a_ is b_ for a_, b_ in zip(
            tree_leaves((tp2, ts2["m"], ts2["v"])),
            tree_leaves((tp, ts["m"], ts["v"]))))
        for b_, a_ in zip(before, tree_leaves(tg)):
            assert torch.equal(b_, a_)
        tp, ts = tp2, ts2
        close(tn, jn, ADAM_TOL)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for name in ("m", "v"):
            for a, b in zip(tree_leaves(ts[name]),
                            jax.tree.leaves(js[name])):
                close(a, b, ADAM_TOL)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            close(a, b, ADAM_TOL)


def test_global_norm_and_no_clip():
    rng = np.random.default_rng(6)
    g = {"x": rng.normal(0, 3, (40,)).astype(np.float32),
         "y": rng.normal(0, 3, (8, 8)).astype(np.float32)}
    tg = tree_map(torch.from_numpy, g)
    close(PO.global_norm(tg), JO.global_norm(jax.tree.map(jnp.asarray, g)),
          ADAM_TOL)
    p = tree_map(torch.zeros_like, tg)
    cfg = PO.OptConfig(lr=1.0, warmup_steps=1, grad_clip=0.0,
                       weight_decay=0.0)
    new, _, _ = PO.adamw_update(p, tg, PO.adamw_init(p), cfg)
    # first step, no clip: -lr * g / (|g| + eps)
    close(new["x"], -np.sign(g["x"]), dict(rtol=1e-6, atol=1e-6))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def two_steps_jax(cfg, tree, opt, batches):
    step = jax.jit(JT.make_train_step(cfg, opt))
    p = jax.tree.map(jnp.asarray, tree)
    s = JO.adamw_init(p)
    metrics = []
    for nb in batches:
        p, s, m = step(p, s, jx(nb))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), metrics


def steps_port(cfg, tree, opt, batches):
    step = PT.make_train_step(cfg, opt)
    p = params_from_jax(cfg, tree, device="cpu")
    s = PO.adamw_init(p)
    metrics = []
    for nb in batches:
        p, s, m = step(p, s, pt(nb))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return p, s, metrics


@pytest.mark.parametrize("arch", FAMILIES)
def test_two_train_steps_match(arch):
    cfg, tree = weights(arch)
    batches = [batch(cfg, seed=10), batch(cfg, seed=11)]
    jopt = JO.OptConfig(lr=1e-3, warmup_steps=1)
    popt = PO.OptConfig(lr=1e-3, warmup_steps=1)
    jp, js, jm = two_steps_jax(cfg, tree, jopt, batches)
    p, s, m = steps_port(cfg, tree, popt, batches)
    for (l, n), (jl, jn) in zip(m, jm):
        close(l, jl, LOSS_TOL)
        close(n, jn, dict(rtol=GRAD_RTOL, atol=0))
    want = params_from_jax(cfg, jp, device="cpu")
    diff = torch.cat([(a - b).abs().flatten() for a, b in
                      zip(tree_leaves(p), tree_leaves(want))])
    assert float(diff.max()) <= 2 * popt.lr * len(batches)
    share = float((diff <= STEP_PARAM_ATOL).float().mean())
    assert share >= STEP_PARAM_SHARE, (share, float(diff.max()))
    assert int(s["step"]) == 2


def test_grad_accum_equals_whole_batch():
    cfg, tree = weights("rwkv6-1.6b")
    nb = batch(cfg, seed=12)
    out = {}
    for k in (1, 2):
        opt = PO.OptConfig(lr=1e-3, warmup_steps=1, grad_accum=k)
        loss, grads = PT.make_grad_fn(cfg, opt)(
            params_from_jax(cfg, tree, device="cpu"), pt(nb))
        out[k] = loss, tree_leaves(grads)
    close(out[2][0], out[1][0], SELF_TOL)
    for a, b in zip(out[2][1], out[1][1]):
        close(a, b, SELF_TOL)
    # and the JAX package's micro-batched step gives the same loss
    jopt = JO.OptConfig(lr=1e-3, warmup_steps=1, grad_accum=2)
    _, _, jm = two_steps_jax(cfg, tree, jopt, [nb])
    close(out[2][0], jm[0][0], LOSS_TOL)
    with pytest.raises(ValueError):
        PT.make_grad_fn(cfg, PO.OptConfig(grad_accum=3))(
            params_from_jax(cfg, tree, device="cpu"), pt(nb))


@pytest.mark.parametrize("knob", ["gather_dtype", "grad_dtype"])
def test_bf16_knobs_match(knob):
    """bf16 parameter casts before use, or gradient casts before the
    reduction: the same roundings in both packages (round to nearest
    even), so losses agree as in float32; gradient norms within bf16's
    relative step (2^-8)."""
    cfg, tree = weights("rwkv6-1.6b")
    nb = [batch(cfg, seed=13)]
    jopt = JO.OptConfig(lr=1e-3, warmup_steps=1, **{knob: "bfloat16"})
    popt = PO.OptConfig(lr=1e-3, warmup_steps=1, **{knob: "bfloat16"})
    jp, _, jm = two_steps_jax(cfg, tree, jopt, nb)
    p, _, m = steps_port(cfg, tree, popt, nb)
    close(m[0][0], jm[0][0], LOSS_TOL)
    close(m[0][1], jm[0][1], dict(rtol=2 ** -8, atol=0))
    # parameters stay float32 either way
    assert all(t.dtype == torch.float32 for t in tree_leaves(p))
    if knob == "grad_dtype":
        grads = PT.make_grad_fn(cfg, popt)(
            params_from_jax(cfg, tree, device="cpu"), pt(nb[0]))[1]
        assert all(g.dtype == torch.bfloat16 for g in tree_leaves(grads))


def test_train_step_through_a_kernel_raises():
    """The kernels have no backward: a train step whose attention would
    run the flash kernel raises, as the JAX package's grad does at its
    Pallas call, instead of losing the q/k/v gradients."""
    cfg, tree = weights("h2o-danube-1.8b")
    cfg = dataclasses.replace(cfg, attention_impl="pallas")
    step = PT.make_train_step(cfg, PO.OptConfig())
    p = params_from_jax(cfg, tree, device="cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        step(p, PO.adamw_init(p), pt(batch(cfg)))


def test_attention_pallas_in_train_mode_raises():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 16, 4, 16))
                                .astype(np.float32)).requires_grad_(True)
               for _ in range(3))
    pos = torch.arange(16)[None]
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        PL.attention(q, k, v, pos, pos, impl="pallas", chunk=16)
    # outside grad mode, or for inputs that need no grad, it runs
    with torch.no_grad():
        out = PL.attention(q, k, v, pos, pos, impl="pallas", chunk=16)
    ref = PL.attention(q.detach(), k.detach(), v.detach(), pos, pos,
                       impl="naive")
    close(out, ref, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("kernel", ["wkv6", "rglru_scan"])
def test_recurrent_kernels_raise_under_autograd(kernel):
    from repro_torch.kernels import rglru_scan, wkv6
    x = torch.rand(1, 8, 2, 8) * 0.5 + 0.25
    if kernel == "wkv6":
        args = [x.clone().requires_grad_(True), x.clone(), x.clone(),
                x.clone(), torch.zeros(2, 8)]
        fn = wkv6
    else:
        args = [x[..., 0].clone().requires_grad_(True), x[..., 0].clone()]
        fn = rglru_scan
    with pytest.raises(RuntimeError, match=f"{kernel} has no backward"):
        fn(*args)
    with torch.no_grad():
        fn(*args)


# ---------------------------------------------------------------------------
# abstract state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_abstract_train_state_matches(arch):
    cfg = pconfigs.smoke_config(arch)
    ap, astate = PT.abstract_train_state(cfg)
    rp, rstate = PT.init_train_state(cfg, torch.Generator().manual_seed(0))
    a_leaves = tree_leaves((ap, astate))
    r_leaves = tree_leaves((rp, rstate))
    assert all(t.device.type == "meta" for t in a_leaves)
    assert [(t.shape, t.dtype) for t in a_leaves] == \
        [(t.shape, t.dtype) for t in r_leaves]
    # the JAX package's abstract tree, restacked into the port's layout
    jparams, jstate = JT.abstract_train_state(jconfigs.smoke_config(arch))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jparams)
    want = params_from_jax(cfg, zeros, device="meta")
    assert [(t.shape, t.dtype) for t in tree_leaves(ap)] == \
        [(t.shape, t.dtype) for t in tree_leaves(want)]
    assert astate["step"].shape == jstate["step"].shape == ()
    assert str(jstate["step"].dtype) == "int32" and \
        astate["step"].dtype == torch.int32
