"""Segmented sums and the masked column select of the PyTorch port
against the JAX package's Pallas kernels (interpret mode, their default
on the CPU) and oracles, on identical numpy inputs.

The port's wrappers run their plain versions on CPU tensors; the CUDA
kernels themselves are held against those plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerances:
* segsum / segsum_windowed: rtol=1e-5, atol=1e-4 in float32 (the JAX
  package's own tolerance between its kernels and ``segment_sum``: the
  one-hot matmul sums in another order); rtol=atol=2e-2 for bf16 values
  (the JAX package's own); exact for unit values (integer counts);
* spgemm_sel: rtol=atol=1e-5 (the JAX package's own), exact where each
  (row, j) has at most one stored hit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.segsum import segsum as jsegsum
from repro.kernels.segsum import segsum_windowed as jsegsum_windowed
from repro.kernels.spmm import spgemm_sel as jspgemm_sel
from repro.kernels.spmm import spmm_ell as jspmm_ell
from repro_torch.device import set_device
from repro_torch.kernels import (ops, segsum, segsum_ref, segsum_windowed,
                                 spgemm_sel, spgemm_sel_ref, spmm_ell)

SEG_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SEL_TOL = dict(rtol=1e-5, atol=1e-5)
RINGS = ("plus_times", "max_times")
# (nnz, nseg, block_nnz, block_seg) of the JAX package's segsum tests
SEGSUM_SHAPES = [(100, 17, 32, 8), (1000, 300, 256, 128),
                 (5000, 64, 1024, 64), (7, 3, 1024, 1024)]
WINDOWED_SHAPES = [(5000, 300, 512, 512), (20000, 5000, 1024, 1024),
                   (500, 64, 256, 256), (777, 100, 128, 256)]
# (R, C, K, B, block_rows) of the JAX package's spgemm_sel tests
SEL_SHAPES = [(64, 256, 4, 8, 32), (100, 64, 6, 5, 16), (13, 40, 2, 3, 8)]


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def seg_case(nnz, nseg, seed, sort=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, nseg, nnz).astype(np.int32)
    if sort:
        ids.sort()
    return ids, rng.normal(0, 1, nnz).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


class TestSegsum:
    @pytest.mark.parametrize("nnz,nseg,bn,bs", SEGSUM_SHAPES)
    def test_matches_pallas(self, nnz, nseg, bn, bs):
        ids, vals = seg_case(nnz, nseg, seed=nnz)
        want = jsegsum(jnp.asarray(ids), jnp.asarray(vals), nseg,
                       block_nnz=bn, block_seg=bs)
        got = segsum(t(ids), t(vals), nseg)
        assert got.dtype == torch.float32 and got.shape == (nseg,)
        close(got, want, **SEG_TOL)

    def test_unsorted_ids(self):
        ids, vals = seg_case(512, 40, seed=3, sort=False)
        assert (np.diff(ids) < 0).any()
        want = jsegsum(jnp.asarray(ids), jnp.asarray(vals), 40,
                       block_nnz=128, block_seg=16)
        close(segsum(t(ids), t(vals), 40), want, **SEG_TOL)

    def test_unit_values_count_exactly(self):
        ids, _ = seg_case(512, 40, seed=4, sort=False)
        ones = np.ones(512, np.float32)
        want = jsegsum(jnp.asarray(ids), jnp.asarray(ones), 40,
                       block_nnz=128, block_seg=16)
        got = segsum(t(ids), t(ones), 40)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got.sum()) == 512.0

    def test_bf16_values(self):
        ids, vals = seg_case(256, 31, seed=5)
        jv = jnp.asarray(vals).astype(jnp.bfloat16)
        want = jsegsum(jnp.asarray(ids), jv, 31, block_nnz=64, block_seg=32)
        tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(
            torch.bfloat16)
        got = segsum(t(ids), tv, 31)
        assert got.dtype == torch.float32
        close(got, want, **BF16_TOL)
        # the same bf16 values summed in float32: as the JAX oracle does
        close(got, jref.segsum_ref(jnp.asarray(ids), jv, 31), **SEG_TOL)

    def test_padding_and_out_of_range_dropped(self):
        """-1 (the ELL's padding) and ids past the last segment add
        nothing, as in the Pallas kernel and ``segment_sum``."""
        ids, vals = seg_case(300, 20, seed=6, sort=False)
        ids[::7] = -1
        ids[::11] = 20
        ids[::13] = 1000
        want = jsegsum(jnp.asarray(ids), jnp.asarray(vals), 20,
                       block_nnz=64, block_seg=8)
        close(segsum(t(ids), t(vals), 20), want, **SEG_TOL)
        close(segsum(t(ids), t(vals), 20),
              jref.segsum_ref(jnp.asarray(ids), jnp.asarray(vals), 20),
              **SEG_TOL)

    def test_int64_ids(self):
        ids, vals = seg_case(200, 10, seed=7, sort=False)
        want = jsegsum(jnp.asarray(ids), jnp.asarray(vals), 10,
                       block_nnz=64, block_seg=8)
        close(segsum(t(ids.astype(np.int64)), t(vals), 10), want, **SEG_TOL)

    def test_sparse_million_segments(self):
        ids, vals = seg_case(2048, 1_000_000, seed=9, sort=False)
        want = jref.segsum_ref(jnp.asarray(ids), jnp.asarray(vals),
                               1_000_000)
        close(segsum(t(ids), t(vals), 1_000_000), want, **SEG_TOL)

    def test_empty_returns_zeros(self):
        got = segsum(torch.zeros(0, dtype=torch.int32), torch.zeros(0), 5)
        assert got.shape == (5,) and not got.any()


class TestSegsumWindowed:
    @pytest.mark.parametrize("nnz,nseg,bn,bs", WINDOWED_SHAPES)
    def test_matches_pallas(self, nnz, nseg, bn, bs):
        ids, vals = seg_case(nnz, nseg, seed=nnz + 1)
        want = jsegsum_windowed(jnp.asarray(ids), jnp.asarray(vals), nseg,
                                block_nnz=bn, block_seg=bs)
        got = segsum_windowed(t(ids), t(vals), nseg)
        assert got.dtype == torch.float32 and got.shape == (nseg,)
        close(got, want, **SEG_TOL)

    def test_sparse_million_segments(self):
        """Blocks spanning many tiles (the Pallas version's spill pass)."""
        ids, _ = seg_case(2048, 1_000_000, seed=9)
        ones = np.ones(2048, np.float32)
        want = jsegsum_windowed(jnp.asarray(ids), jnp.asarray(ones),
                                1_000_000, block_nnz=256, block_seg=256)
        got = segsum_windowed(t(ids), t(ones), 1_000_000)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_bf16_values(self):
        ids, vals = seg_case(1000, 50, seed=10)
        jv = jnp.asarray(vals).astype(jnp.bfloat16)
        want = jsegsum_windowed(jnp.asarray(ids), jv, 50, block_nnz=256,
                                block_seg=256)
        tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(
            torch.bfloat16)
        close(segsum_windowed(t(ids), tv, 50), want, **BF16_TOL)

    def test_one_segment(self):
        ids = np.full(3000, 4, np.int32)
        ones = np.ones(3000, np.float32)
        want = jsegsum_windowed(jnp.asarray(ids), jnp.asarray(ones), 9,
                                block_nnz=256, block_seg=256)
        got = segsum_windowed(t(ids), t(ones), 9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got[4]) == 3000.0

    def test_equals_segsum(self):
        ids, vals = seg_case(4000, 700, seed=11)
        np.testing.assert_array_equal(
            segsum_windowed(t(ids), t(vals), 700).numpy(),
            segsum(t(ids), t(vals), 700).numpy())


class TestSegsumWrapper:
    def test_cpu_path_counts_no_launch(self):
        ops.reset_launches()
        ids, vals = seg_case(50, 5, seed=1)
        segsum(t(ids), t(vals), 5)
        segsum_windowed(t(ids), t(vals), 5)
        got = ops.kernel_launches()
        assert got["segsum"] == 0 and got["segsum_windowed"] == 0

    @pytest.mark.parametrize("fn", [segsum, segsum_windowed])
    def test_rejects_bad_inputs(self, fn):
        ids, vals = seg_case(16, 4, seed=2)
        with pytest.raises(TypeError):
            fn(t(ids.astype(np.float32)), t(vals), 4)
        with pytest.raises(TypeError):
            fn(t(ids), t(vals.astype(np.float64)), 4)
        with pytest.raises(ValueError):
            fn(t(ids[:-1]), t(vals), 4)
        with pytest.raises(ValueError):
            fn(t(ids.reshape(4, 4)), t(vals.reshape(4, 4)), 4)
        with pytest.raises(ValueError):
            fn(t(ids), t(vals), -1)

    def test_plain_version_is_segment_sum(self):
        ids, vals = seg_case(500, 30, seed=12, sort=False)
        ids[::5] = -1
        close(segsum_ref(t(ids), t(vals), 30),
              jref.segsum_ref(jnp.asarray(ids), jnp.asarray(vals), 30),
              **SEG_TOL)


def rand_ell(rng, R, C, K, empty_rows=()):
    """tests/test_kernels.py's ``_rand_ell``: padding slots drawn with
    the columns, optionally some wholly empty rows."""
    ecols = np.asarray(rng.integers(-1, C, (R, K)), np.int32)
    evals = rng.normal(0, 1, (R, K)).astype(np.float32)
    for r in empty_rows:
        ecols[r] = -1
    evals[ecols == -1] = 0.0
    return ecols, evals


class TestSpgemmSel:
    @pytest.mark.parametrize("R,C,K,B,br", SEL_SHAPES)
    @pytest.mark.parametrize("ring", RINGS)
    def test_matches_pallas(self, R, C, K, B, br, ring):
        rng = np.random.default_rng(R * B)
        ecols, evals = rand_ell(rng, R, C, K, empty_rows=(0,))
        sel = rng.choice(C, B, replace=False).astype(np.int32)
        want = jspgemm_sel(jnp.asarray(ecols), jnp.asarray(evals),
                           jnp.asarray(sel), block_rows=br, ring=ring)
        got = spgemm_sel(t(ecols), t(evals), t(sel), ring=ring)
        assert got.dtype == torch.float32 and got.shape == (R, B)
        assert not got[0].any()                  # the empty row
        close(got, want, **SEL_TOL)
        close(spgemm_sel_ref(t(ecols), t(evals), t(sel), ring),
              jref.spgemm_sel_ref(jnp.asarray(ecols), jnp.asarray(evals),
                                  jnp.asarray(sel), ring=ring), **SEL_TOL)

    def test_equals_spmm_with_onehot(self):
        """Exact under plus_times against the port's spmm_ell and the
        one-hot X; under max_times too for non-negative payloads."""
        rng = np.random.default_rng(17)
        R, C, K, B = 40, 80, 3, 6
        ecols, evals = rand_ell(rng, R, C, K)
        sel = rng.choice(C, B, replace=False).astype(np.int32)
        onehot = np.zeros((C, B), np.float32)
        onehot[sel, np.arange(B)] = 1.0
        ys = spgemm_sel(t(ecols), t(evals), t(sel))
        np.testing.assert_array_equal(
            ys.numpy(), spmm_ell(t(ecols), t(evals), t(onehot)).numpy())
        jys = jspgemm_sel(jnp.asarray(ecols), jnp.asarray(evals),
                          jnp.asarray(sel), block_rows=8)
        jym = jspmm_ell(jnp.asarray(ecols), jnp.asarray(evals),
                        jnp.asarray(onehot), block_rows=8, block_cols=16)
        close(ys, jys, **SEL_TOL)
        close(ys, jym, **SEL_TOL)
        pos = np.where(ecols >= 0, np.abs(evals), 0.0).astype(np.float32)
        np.testing.assert_array_equal(
            spgemm_sel(t(ecols), t(pos), t(sel), ring="max_times").numpy(),
            spmm_ell(t(ecols), t(pos), t(onehot), ring="max_times").numpy())

    def test_max_times_negative_hits_survive(self):
        ecols = np.asarray([[0, 1, -1]], np.int32)
        evals = np.asarray([[-2.0, -3.0, 0.0]], np.float32)
        sel = np.asarray([0, 1, 5], np.int32)
        want = jspgemm_sel(jnp.asarray(ecols), jnp.asarray(evals),
                           jnp.asarray(sel), block_rows=8, ring="max_times")
        got = spgemm_sel(t(ecols), t(evals), t(sel), ring="max_times")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[0].tolist() == [-2.0, -3.0, 0.0]
        onehot = np.zeros((6, 3), np.float32)
        onehot[sel, np.arange(3)] = 1.0
        assert spmm_ell(t(ecols), t(evals), t(onehot),
                        ring="max_times")[0].tolist() == [0.0, 0.0, 0.0]

    def test_repeated_column_in_a_row(self):
        ecols = np.asarray([[2, 2, 5, -1], [5, 2, 2, 2]], np.int32)
        evals = np.asarray([[1.5, -4.0, 2.0, 0.0], [3.0, 0.25, 0.5, -1.0]],
                           np.float32)
        sel = np.asarray([2, 5, 7], np.int32)
        for ring in RINGS:
            want = jspgemm_sel(jnp.asarray(ecols), jnp.asarray(evals),
                               jnp.asarray(sel), block_rows=8, ring=ring)
            close(spgemm_sel(t(ecols), t(evals), t(sel), ring=ring), want,
                  **SEL_TOL)

    def test_empty_pack_and_selection(self):
        ecols, evals = rand_ell(np.random.default_rng(1), 5, 10, 3)
        sel = np.asarray([1, 2], np.int32)
        assert spgemm_sel(t(ecols[:0]), t(evals[:0]), t(sel)).shape == (0, 2)
        assert spgemm_sel(t(ecols), t(evals), t(sel[:0])).shape == (5, 0)
        none = spgemm_sel(t(ecols[:, :0]), t(evals[:, :0]), t(sel),
                          ring="max_times")
        assert none.shape == (5, 2) and not none.any()

    def test_rejects_bad_inputs(self):
        ecols, evals = rand_ell(np.random.default_rng(2), 5, 10, 3)
        sel = np.asarray([1, 2], np.int32)
        with pytest.raises(TypeError):
            spgemm_sel(t(ecols.astype(np.int64)), t(evals), t(sel))
        with pytest.raises(ValueError):
            spgemm_sel(t(ecols), t(evals), t(sel.astype(np.float32)))
        with pytest.raises(ValueError):
            spgemm_sel(t(ecols), t(evals), t(sel[None]))
        with pytest.raises(ValueError):
            spgemm_sel(t(ecols), t(evals), t(sel), ring="min_plus")
        ops.reset_launches()
        spgemm_sel(t(ecols), t(evals), t(sel))
        assert ops.kernel_launches()["spgemm_sel"] == 0
