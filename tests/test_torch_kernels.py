"""ELL SpMV/SpMM of the PyTorch port against the JAX package's Pallas
kernels (interpret mode) and oracles, on identical numpy inputs.

The port's wrappers run their plain versions on CPU tensors; the CUDA
kernels themselves are held against those plain versions on the card
by tests/test_torch_cuda.py and ``chip_smoke.py``.
Tolerance: rtol=1e-5, atol=1e-6 — fp32 in both, summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.spmm import spmm_ell as jspmm_ell
from repro.kernels.spmv import EllOverflowError as JEllOverflowError
from repro.kernels.spmv import csr_to_ell as jcsr_to_ell
from repro.kernels.spmv import spmv_ell as jspmv_ell
from repro_torch.device import set_device
from repro_torch.kernels import (EllOverflowError, csr_to_ell, ops, spmm_ell,
                                 spmv_ell)

RTOL, ATOL = 1e-5, 1e-6
RINGS = ("plus_times", "max_times")


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def ell_case(R, C, K, seed, empty_frac=0.2, signed=True):
    """A random ELL pack with padding (-1) slots and wholly empty rows;
    every real column is < C (the oracle and the kernel differ past C)."""
    rng = np.random.default_rng(seed)
    ecols = rng.integers(0, C, (R, K)).astype(np.int32)
    ecols[rng.random((R, K)) < 0.3] = -1
    ecols[rng.random(R) < empty_frac] = -1
    evals = rng.normal(0, 1, (R, K)).astype(np.float32)
    if not signed:
        evals = np.abs(evals)
    evals[ecols < 0] = 0.0
    return ecols, evals


def xvec(C, seed, signed=True, b=None):
    rng = np.random.default_rng(seed + 1000)
    shape = (C,) if b is None else (C, b)
    x = rng.normal(0, 1, shape).astype(np.float32)
    return x if signed else np.abs(x)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class TestSpmvEll:
    @pytest.mark.parametrize("ring", RINGS)
    @pytest.mark.parametrize("R,C,K", [(64, 256, 4), (100, 500, 6),
                                       (13, 40, 2)])
    def test_matches_pallas_and_oracle(self, R, C, K, ring):
        ecols, evals = ell_case(R, C, K, seed=R + K)
        x = xvec(C, seed=R)
        got = spmv_ell(t(ecols), t(evals), t(x), ring=ring).numpy()
        pallas = np.asarray(jspmv_ell(jnp.asarray(ecols), jnp.asarray(evals),
                                      jnp.asarray(x), block_rows=32,
                                      block_cols=128, ring=ring,
                                      interpret=True))
        oracle = np.asarray(jref.spmv_ell_ref(jnp.asarray(ecols),
                                              jnp.asarray(evals),
                                              jnp.asarray(x), ring=ring))
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)

    def test_max_times_signed_not_clamped(self):
        """All-negative products keep their (negative) maximum; padding
        and empty rows give 0."""
        ecols = np.asarray([[0, 1, -1], [-1, -1, -1], [2, -1, -1]], np.int32)
        evals = np.asarray([[1., 2., 0.], [0., 0., 0.], [3., 0., 0.]],
                           np.float32)
        x = np.asarray([-1., -3., -2.], np.float32)
        got = spmv_ell(t(ecols), t(evals), t(x), ring="max_times").numpy()
        np.testing.assert_array_equal(got, [-1., 0., -6.])
        pallas = np.asarray(jspmv_ell(jnp.asarray(ecols), jnp.asarray(evals),
                                      jnp.asarray(x), block_rows=8,
                                      block_cols=16, ring="max_times",
                                      interpret=True))
        np.testing.assert_array_equal(got, pallas)

    def test_rejects_bad_inputs(self):
        ecols, evals = ell_case(8, 16, 3, seed=1)
        x = t(xvec(16, seed=1))
        with pytest.raises(TypeError):
            spmv_ell(t(ecols).long(), t(evals), x)
        with pytest.raises(ValueError):
            spmv_ell(t(ecols), t(evals), x.double())
        with pytest.raises(ValueError):
            spmv_ell(t(ecols), t(evals)[:, :2].contiguous(), x)
        with pytest.raises(ValueError):
            spmv_ell(t(ecols), t(evals), x, ring="min_plus")

    def test_cpu_path_counts_no_launch(self):
        ops.reset_launches()
        ecols, evals = ell_case(8, 16, 3, seed=2)
        spmv_ell(t(ecols), t(evals), t(xvec(16, seed=2)))
        spmm_ell(t(ecols), t(evals), t(xvec(16, seed=2, b=3)))
        assert ops.kernel_launches() == {
            "spmv_ell": 0, "spmm_ell": 0, "wkv6": 0, "rglru_scan": 0,
            "flash_attention": 0}


class TestCsrToEll:
    def test_pack_equals_reference_exactly(self):
        rng = np.random.default_rng(5)
        counts = rng.integers(0, 7, 50)
        counts[::9] = 0
        row_ptr = np.concatenate([[0], np.cumsum(counts)])
        cols = rng.integers(0, 300, row_ptr[-1])
        vals = rng.normal(0, 1, row_ptr[-1])
        k_max = int(counts.max())
        ec, ev = csr_to_ell(row_ptr, cols, vals, 50, k_max)
        jc, jv = jcsr_to_ell(row_ptr, cols, vals, 50, k_max)
        assert ec.dtype == np.int32 and ev.dtype == np.float32
        np.testing.assert_array_equal(ec, np.asarray(jc))
        np.testing.assert_array_equal(ev, np.asarray(jv))

    def test_overflow_raises_like_reference(self):
        row_ptr = np.asarray([0, 4, 5, 5])
        cols = np.asarray([0, 1, 2, 3, 1])
        vals = np.ones(5)
        with pytest.raises(EllOverflowError) as e:
            csr_to_ell(row_ptr, cols, vals, 3, k_max=2)
        with pytest.raises(JEllOverflowError) as je:
            jcsr_to_ell(row_ptr, cols, vals, 3, k_max=2)
        assert (e.value.n_over, e.value.worst, e.value.k_max) == \
            (je.value.n_over, je.value.worst, je.value.k_max) == (1, 4, 2)
        ec, _ = csr_to_ell(row_ptr, cols, vals, 3, k_max=2,
                           on_overflow="truncate")
        np.testing.assert_array_equal(ec, [[0, 1], [1, -1], [-1, -1]])
        with pytest.raises(ValueError):
            csr_to_ell(row_ptr, cols, vals, 3, k_max=2, on_overflow="drop")


class TestSpmmEll:
    @pytest.mark.parametrize("ring", RINGS)
    @pytest.mark.parametrize("R,C,K,B", [(64, 256, 4, 8), (37, 90, 3, 5)])
    def test_matches_pallas_and_oracle(self, R, C, K, B, ring):
        ecols, evals = ell_case(R, C, K, seed=R * B)
        X = xvec(C, seed=R, b=B)
        got = spmm_ell(t(ecols), t(evals), t(X), ring=ring).numpy()
        pallas = np.asarray(jspmm_ell(jnp.asarray(ecols), jnp.asarray(evals),
                                      jnp.asarray(X), block_rows=32,
                                      block_cols=128, ring=ring,
                                      interpret=True))
        oracle = np.asarray(jref.spmm_ell_ref(jnp.asarray(ecols),
                                              jnp.asarray(evals),
                                              jnp.asarray(X), ring=ring))
        assert got.shape == (R, B)
        np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("ring", RINGS)
    def test_b1_equals_spmv(self, ring):
        ecols, evals = ell_case(50, 120, 4, seed=9)
        X = xvec(120, seed=9, b=1)
        y2 = spmm_ell(t(ecols), t(evals), t(X), ring=ring)[:, 0]
        y1 = spmv_ell(t(ecols), t(evals), t(X[:, 0]), ring=ring)
        np.testing.assert_array_equal(y2.numpy(), y1.numpy())

    def test_rejects_1d_x(self):
        ecols, evals = ell_case(8, 16, 3, seed=3)
        with pytest.raises(ValueError):
            spmm_ell(t(ecols), t(evals), t(xvec(16, seed=3)))


class TestOnCuda:
    def test_cpu_and_mixed(self):
        a = torch.zeros(2)
        assert ops.on_cuda(a, a) is False
        with pytest.raises(ValueError):
            ops.on_cuda(a, torch.zeros(2, device="meta"))
