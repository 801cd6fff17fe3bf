"""The port's RG-LRU scan and block against the JAX package's, on
identical numpy inputs.

On CPU tensors the port's ``rglru_scan`` wrapper runs its plain version
(``rglru_scan_ref``, the sequential recurrence); it is held against the
JAX Pallas kernel in interpret mode and the JAX oracle.  The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerances:
* rtol=1e-4, atol=1e-5 against the Pallas kernel — the JAX package's own
  tolerance between its kernel (a log-depth doubling scan) and the
  sequential oracle (tests/test_kernels.py);
* rtol=atol=1e-5 between like forms (float32, another rounding order);
* rtol=atol=1e-4 for the block, whose gates and projections are float32
  matmuls summed in another order.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.rglru import rglru_scan as jrglru
from repro.models import blocks as JB
from repro_torch.device import set_device
from repro_torch.kernels import ops, rglru_scan, rglru_scan_ref
from repro_torch.models import blocks as PB

KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)
LIKE_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
# (S, C, block_t, block_c) of the JAX package's own RG-LRU kernel test
SHAPES = [(64, 128, 16, 64), (128, 256, 64, 128), (32, 64, 32, 64)]


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def scan_inputs(B, S, C, seed):
    """a = sigmoid(normal) in (0, 1), b = 0.1 normal — as the JAX test."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(0, 1, (B, S, C))))).astype(np.float32)
    b = (rng.normal(0, 1, (B, S, C)) * 0.1).astype(np.float32)
    return a, b


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("S,C,bt,bc", SHAPES)
def test_matches_pallas_interpret(S, C, bt, bc):
    a, b = scan_inputs(2, S, C, seed=S + C)
    out = rglru_scan(t(a), t(b))
    want = jrglru(jnp.asarray(a), jnp.asarray(b), block_t=bt, block_c=bc,
                  interpret=True)
    assert out.shape == (2, S, C) and out.dtype == torch.float32
    close(out, want, KERNEL_TOL)


@pytest.mark.parametrize("S,C,bt,bc", SHAPES)
def test_matches_reference_oracle(S, C, bt, bc):
    a, b = scan_inputs(2, S, C, seed=S + C + 1)
    close(rglru_scan(t(a), t(b)),
          jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)), LIKE_TOL)


@pytest.mark.parametrize("S", [1, 7, 64, 100])
def test_linear_scan_matches_plain_version(S):
    """The model's plain log-depth scan (its ``rglru_impl="scan"``
    path) against the sequential recurrence, ragged S included."""
    a, b = map(t, scan_inputs(3, S, 40, seed=S))
    close(PB.linear_scan(a, b), rglru_scan_ref(a, b), LIKE_TOL)


def test_ref_keeps_input_dtype():
    a, b = scan_inputs(1, 16, 8, seed=3)
    out = rglru_scan_ref(t(a).to(torch.bfloat16), t(b).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    want = jref.rglru_scan_ref(jnp.asarray(a, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16))
    close(out.float(), np.asarray(want, np.float32),
          dict(rtol=1e-2, atol=1e-2))


def test_strided_inputs():
    a, b = scan_inputs(2, 20, 16, seed=4)
    views = [t(np.concatenate([x, np.zeros_like(x)], axis=-1))[..., :16]
             for x in (a, b)]
    assert not views[0].is_contiguous()
    close(rglru_scan(*views), rglru_scan(t(a), t(b)), dict(rtol=0, atol=0))


def test_cpu_runs_plain_version_without_launch():
    before = ops.kernel_launches()["rglru_scan"]
    rglru_scan(*map(t, scan_inputs(1, 8, 16, seed=5)))
    assert ops.kernel_launches()["rglru_scan"] == before


@pytest.mark.parametrize("case", ["dtype", "rank", "shapes", "strides"])
def test_rejects_what_the_kernel_does_not_take(case):
    a, b = map(t, scan_inputs(2, 8, 16, seed=6))
    if case == "dtype":
        a, b = a.double(), b.double()
    elif case == "rank":
        a, b = a[0], b[0]
    elif case == "shapes":
        b = b[:, :4]
    else:
        b = b.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        rglru_scan(a, b)


def test_mixed_devices_raise():
    a, b = map(t, scan_inputs(1, 8, 16, seed=7))
    with pytest.raises(ValueError):
        rglru_scan(a, b.to("meta"))


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rglru_weights():
    """One RG-LRU block of the recurrentgemma smoke config (float32) with
    its zero inits (norm scale, conv bias) perturbed."""
    import jax
    cfg = jconfigs.smoke_config("recurrentgemma-9b")
    p = jax.tree.map(np.asarray, JB.init_rglru(cfg, jax.random.key(1)))
    rng = np.random.default_rng(1)
    p["ln"] = rng.normal(0, 0.1, p["ln"].shape).astype(np.float32)
    p["conv_b"] = rng.normal(0, 0.1, p["conv_b"].shape).astype(np.float32)
    return cfg, p


def rglru_cache(cfg, B, seed):
    rng = np.random.default_rng(seed)
    Dr = cfg.d_rnn_resolved
    return (rng.normal(0, 1, (B, Dr)).astype(np.float32),
            rng.normal(0, 1, (B, cfg.conv_width - 1, Dr)).astype(np.float32))


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("mode,S", [("prefill", 32), ("prefill", 1),
                                    ("train", 12), ("decode", 1),
                                    ("decode", 3)])
def test_apply_rglru_matches(rglru_weights, impl, mode, S):
    """One block in every branch of the JAX package's order, including
    its quirks: decode with S > 1 scans from zero and returns no cache;
    prefill with S == 1 returns no cache."""
    cfg, p = rglru_weights
    cfg = dataclasses.replace(cfg, rglru_impl=impl)
    B = 2
    x = np.random.default_rng(S).normal(0, 1, (B, S, cfg.d_model)).astype(
        np.float32)
    cache = rglru_cache(cfg, B, seed=S + 10)
    pos = np.zeros((B, S), np.int32)
    jy, jc = JB.apply_rglru(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        JB.Ctx(jnp.asarray(pos), mode,
               JB.RGLRUCache(*map(jnp.asarray, cache))), cfg)
    py, pc = PB.apply_rglru(
        {k: t(v) for k, v in p.items()}, t(x),
        PB.Ctx(t(pos), mode, PB.RGLRUCache(*map(t, cache))), cfg)
    close(py, jy, BLOCK_TOL)
    assert (pc is None) == (jc is None)
    if jc is not None:
        for g, w in zip(pc, jc):
            assert tuple(g.shape) == w.shape
            close(g, w, BLOCK_TOL)


def test_kernel_branch_order(rglru_weights, monkeypatch):
    """The rglru_scan wrapper is reached exactly where the JAX package
    reaches its Pallas kernel: prefill with ``rglru_impl="pallas"``."""
    cfg, p = rglru_weights
    calls = []
    real = PB.rglru_scan
    monkeypatch.setattr(PB, "rglru_scan",
                        lambda a, b: calls.append(a.shape) or real(a, b))
    params = {k: t(v) for k, v in p.items()}
    cache = PB.RGLRUCache(*map(t, rglru_cache(cfg, 2, seed=3)))
    for impl, mode, S, want in [("pallas", "prefill", 16, 1),
                                ("pallas", "prefill", 1, 1),
                                ("pallas", "train", 16, 0),
                                ("pallas", "decode", 1, 0),
                                ("pallas", "decode", 4, 0),
                                ("scan", "prefill", 16, 0)]:
        calls.clear()
        x = torch.zeros((2, S, cfg.d_model))
        PB.apply_rglru(params, x, PB.Ctx(torch.zeros((2, S)), mode, cache),
                       dataclasses.replace(cfg, rglru_impl=impl))
        assert len(calls) == want, (impl, mode, S)
