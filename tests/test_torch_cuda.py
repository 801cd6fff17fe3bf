"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and skips without one; imports nothing of JAX, so
it also runs where only the port's dependencies are installed:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol=1e-5, atol=1e-6 for the ELL kernels — fp32, another
summation order (the kernel may fuse multiply-add); rtol=atol=1e-4 for
wkv6, whose recurrence carries fp32 rounding across time steps, and for
a small model's prefill on the card against the CPU (fp32 matmuls, TF32
off, through two layers).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import Assoc, eval_batch, lazy
from repro_torch.core import expr as X
from repro_torch.db import DB, put
from repro_torch.device import set_device
from repro_torch.kernels import ops, spmm_ell, spmm_ell_ref, spmv_ell, \
    spmv_ell_ref, wkv6, wkv6_ref
from repro_torch.models import init_params, prefill

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-6
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
RINGS = ("plus_times", "max_times")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = set_device("cuda")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    set_device(prev)


def ell_case(R, C, K, seed, dev):
    rng = np.random.default_rng(seed)
    ecols = rng.integers(0, C, (R, K)).astype(np.int32)
    ecols[rng.random((R, K)) < 0.3] = -1
    ecols[rng.random(R) < 0.1] = -1
    evals = rng.normal(0, 1, (R, K)).astype(np.float32)
    evals[ecols < 0] = 0.0
    x = rng.normal(0, 1, C).astype(np.float32)
    Xm = rng.normal(0, 1, (C, 8)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (ecols, evals, x, Xm)]


@pytest.mark.parametrize("ring", RINGS)
def test_kernels_match_plain(card, ring):
    ec, ev, x, Xm = ell_case(5000, 3000, 9, seed=11, dev=card)
    before = ops.kernel_launches()
    y = spmv_ell(ec, ev, x, ring=ring)
    Y = spmm_ell(ec, ev, Xm, ring=ring)
    torch.cuda.synchronize()
    after = ops.kernel_launches()
    assert after["spmv_ell"] == before["spmv_ell"] + 1
    assert after["spmm_ell"] == before["spmm_ell"] + 1
    torch.testing.assert_close(y, spmv_ell_ref(ec, ev, x, ring),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(Y, spmm_ell_ref(ec, ev, Xm, ring),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ring", RINGS)
def test_b1_equals_spmv(card, ring):
    ec, ev, x, _ = ell_case(777, 500, 5, seed=3, dev=card)
    y1 = spmv_ell(ec, ev, x, ring=ring)
    y2 = spmm_ell(ec, ev, x[:, None].contiguous(), ring=ring)[:, 0]
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)


def test_mixed_devices_raise(card):
    ec, ev, x, _ = ell_case(10, 20, 2, seed=4, dev=card)
    with pytest.raises(ValueError):
        spmv_ell(ec, ev, x.cpu())


def test_eval_batch_on_card_matches_cpu(card, monkeypatch):
    monkeypatch.setattr(X, "DEVICE_NNZ_THRESHOLD", 1)
    rng = np.random.default_rng(1)
    rows = np.asarray([f"v{i:04d}" for i in rng.integers(0, 200, 2000)])
    cols = np.asarray([f"v{i:04d}" for i in rng.integers(0, 200, 2000)])
    T = DB("Tedge", "TedgeT")
    put(T, Assoc(rows, cols, rng.integers(1, 5, 2000).astype(float)))
    vecs = [Assoc(np.asarray([f"v{j:04d}"]), np.asarray([f"s{j}"]),
                  np.asarray([1.0])) for j in range(8)]
    k0 = ops.kernel_launches()
    on_card = eval_batch([T.lazy() * lazy(v) for v in vecs])
    assert ops.kernel_launches()["spmm_ell"] == k0["spmm_ell"] + 1
    set_device("cpu")
    on_cpu = eval_batch([T.lazy() * lazy(v) for v in vecs])
    assert all(a == b for a, b in zip(on_card, on_cpu))


def wkv_case(B, S, H, Dh, seed, dev):
    """r, k, v normal; w in (0.45, 0.95); u x 0.1."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, S, H, Dh)) for _ in range(3))
    w = 0.5 / (1 + np.exp(-rng.normal(0, 1, (B, S, H, Dh)))) + 0.45
    u = rng.normal(0, 1, (H, Dh)) * 0.1
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (r, k, v, w, u)]


@pytest.mark.parametrize("Dh", [16, 64])
def test_wkv6_matches_plain(card, Dh):
    args = wkv_case(2, 96, 3, Dh, seed=Dh, dev=card)
    before = ops.kernel_launches()["wkv6"]
    out, state = wkv6(*args)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["wkv6"] == before + 1
    want_out, want_state = wkv6_ref(*args)
    torch.testing.assert_close(out, want_out, **WKV_TOL)
    torch.testing.assert_close(state, want_state, **WKV_TOL)
    wkv6(*args)
    assert ops.kernel_launches()["wkv6"] == before + 2


def test_wkv6_strided_views(card):
    """The kernel reads views of wider tensors through their strides."""
    r, k, v, w, u = wkv_case(2, 40, 2, 32, seed=1, dev=card)
    views = [torch.cat([a, torch.zeros_like(a)], dim=-1)[..., :32]
             for a in (r, k, v, w)]
    assert not views[0].is_contiguous()
    got = wkv6(*views, u)
    want = wkv6(r, k, v, w, u)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, rtol=0, atol=0)


def test_wkv6_rejects_mixed_devices_and_head_dims(card):
    r, k, v, w, u = wkv_case(1, 8, 2, 16, seed=2, dev=card)
    before = ops.kernel_launches()["wkv6"]
    with pytest.raises(ValueError):
        wkv6(r, k, v, w, u.cpu())
    r12, k12, v12, w12 = (a[..., :12].contiguous() for a in (r, k, v, w))
    with pytest.raises(ValueError):
        wkv6(r12, k12, v12, w12, u[:, :12].contiguous())
    with pytest.raises(TypeError):
        wkv6(r.double(), k, v, w, u)
    assert ops.kernel_launches()["wkv6"] == before


def test_prefill_on_card_matches_cpu(card):
    """A small rwkv6 prefill through the kernel (S a multiple of the
    chunk) against the same call on the CPU (plain recurrence)."""
    cfg = dataclasses.replace(smoke_config("rwkv6-1.6b"), rwkv_impl="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 4 * cfg.rwkv_chunk)).astype(np.int32))
    cpu_logits, cpu_caches = prefill(params, {"tokens": toks}, cfg, 64)
    on_card = {k: v.to(card) if k != "layers" else
               [{"rwkv": {n: t.to(card) for n, t in lay["rwkv"].items()}}
                for lay in v] for k, v in params.items()}
    before = ops.kernel_launches()["wkv6"]
    logits, caches = prefill(on_card, {"tokens": toks.to(card)}, cfg, 64)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["wkv6"] == before + cfg.n_layers
    torch.testing.assert_close(logits.cpu(), cpu_logits, **WKV_TOL)
    for got, want in zip(caches, cpu_caches):
        for g, x in zip(got, want):
            torch.testing.assert_close(g.cpu(), x, **WKV_TOL)
