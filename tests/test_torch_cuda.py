"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device and skips without one; imports nothing of JAX, so
it also runs where only the port's dependencies are installed:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: rtol=1e-5, atol=1e-6 — fp32, another summation order (the
kernel may fuse multiply-add).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Assoc, eval_batch, lazy
from repro_torch.core import expr as X
from repro_torch.db import DB, put
from repro_torch.device import set_device
from repro_torch.kernels import ops, spmm_ell, spmm_ell_ref, spmv_ell, \
    spmv_ell_ref

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-6
RINGS = ("plus_times", "max_times")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = set_device("cuda")
    yield torch.device("cuda")
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
