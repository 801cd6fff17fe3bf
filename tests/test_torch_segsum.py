"""Segmented sums and the masked column select of the PyTorch port
against the JAX package's Pallas kernels (interpret mode, their default
on the CPU) and oracles, on identical numpy inputs.

The port's wrappers run their plain versions on CPU tensors; the CUDA
kernels themselves are held against those plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.  Here a numpy emulation of
the windowed kernel's algorithm (ranges, their partials, the combine in
range order, the zeros of the gaps) is held against the Pallas kernel and
the plain version at small range sizes.

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
from _hyp import given, settings, st  # hypothesis, skipping when absent

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


def emulate_windowed(ids, vals, n_seg, tile, order=None, shift=0):
    """numpy model of ``segsum_windowed`` in ``csrc/segsum.cu``.

    Range b holds ids [b * tile - shift, (b + 1) * tile - shift) cut to
    [0, nnz) (the kernel shifts the ranges so that all but the first start
    aligned).  Phase 1 takes the ranges in ``order`` (any permutation:
    blocks finish in no order): each stores the runs that begin and end
    inside it, keeps the sums of its first and last runs with how they
    meet its neighbours, and stores zeros for the segments below each of
    its heads (and, in the last range, above the last id).  Phase 2: the
    range where a run that crosses range edges begins adds the partials
    of the ranges it covers, in range order (the kernel reduces each step
    of 128 ranges in a fixed tree), and stores the sum.  Sums are float32.
    Returns ``out`` (NaN where nothing was stored) and each element's
    count of stores."""
    ids = np.asarray(ids, np.int64)
    vals = np.asarray(vals, np.float32)
    nnz = ids.size
    c = np.where(ids < 0, -1, np.minimum(ids, n_seg))   # the kernel's clamp
    out = np.full(n_seg, np.nan, np.float32)
    writes = np.zeros(n_seg, np.int64)

    def store(lo, hi, x):
        lo, hi = max(lo, 0), min(hi, n_seg)
        if lo < hi:
            out[lo:hi] = x
            writes[lo:hi] += 1

    n_ranges = -(-(nnz + shift) // tile)
    parts = [dict() for _ in range(n_ranges)]
    for b in (range(n_ranges) if order is None else order):
        lo, hi = max(0, b * tile - shift), min(nnz, (b + 1) * tile - shift)
        from_prev = lo > 0 and c[lo - 1] == c[lo]
        into_next = hi < nnz and c[hi] == c[hi - 1]
        heads = [i for i in range(lo, hi) if i == 0 or c[i] != c[i - 1]]
        cuts = [lo] + [h for h in heads if h > lo] + [hi]
        for j in range(len(cuts) - 1):
            r = np.float32(0.0)
            for x in vals[cuts[j]:cuts[j + 1]]:
                r = np.float32(r + x)
            first, last = j == 0, j == len(cuts) - 2
            if first:
                parts[b]["first"] = r
            if last:
                parts[b].update(last=r, single=first, from_prev=from_prev,
                                into_next=into_next)
            if not ((first and from_prev) or (last and into_next)):
                store(c[cuts[j]], c[cuts[j]] + 1, r)
        for h in heads:
            below = c[h - 1] if h > 0 else -1
            store(max(below, -1) + 1, c[h], 0.0)
        if hi == nnz:
            store(c[nnz - 1] + 1, n_seg, 0.0)
    for b, p in enumerate(parts):
        if not p["into_next"] or (p["single"] and p["from_prev"]):
            continue
        total, k = p["last"], b + 1
        while True:
            total = np.float32(total + parts[k]["first"])
            if not (parts[k]["single"] and parts[k]["into_next"]):
                break
            k += 1
        end = c[(b + 1) * tile - shift - 1]
        store(end, end + 1, total)
    return out, writes


def windowed_cases():
    """(name, ids, n_seg, tile): sorted ids that stress range edges."""
    rng = np.random.default_rng(21)
    return [
        ("one_run_over_all", np.full(300, 4), 9, 16),
        ("runs_over_many_ranges", np.repeat(np.arange(6),
                                            [100, 3, 57, 1, 40, 77]), 6, 8),
        ("gaps_everywhere", np.repeat([3, 4, 9, 17, 18, 30], 4), 40, 8),
        ("gap_at_range_edge", np.repeat([1, 6, 7, 12], [8, 8, 5, 3]), 15, 8),
        ("range_ends_at_run_end", np.repeat([0, 2, 5, 6], 4), 8, 4),
        ("single_element", np.array([5]), 11, 4),
        ("dropped_ids", np.concatenate([np.full(7, -1), np.repeat(
            [0, 2, 3], 5), np.full(6, 10), np.full(3, 12)]), 10, 8),
        ("random_sorted", np.sort(rng.integers(0, 700, 5000)), 700, 64),
        ("sparse", np.sort(rng.choice(100_000, 400, replace=False)),
         100_000, 32),
    ]


WINDOWED_CASES = windowed_cases()


class TestWindowedEmulation:
    """The windowed kernel's algorithm against the Pallas kernel (ids
    outside [0, n_seg) dropped beforehand, as it has no such ids) and the
    plain version: within SEG_TOL, exactly for unit values, every element
    stored once, and the same bits whatever order the ranges run in."""

    @pytest.mark.parametrize("shift", [0, 3])
    @pytest.mark.parametrize("name,ids,n_seg,tile", WINDOWED_CASES,
                             ids=[c[0] for c in WINDOWED_CASES])
    def test_matches_pallas_and_plain(self, name, ids, n_seg, tile, shift):
        rng = np.random.default_rng(len(ids))
        ids = ids.astype(np.int32)
        for vals in (rng.normal(0, 1, ids.size).astype(np.float32),
                     np.ones(ids.size, np.float32)):
            got, writes = emulate_windowed(ids, vals, n_seg, tile,
                                           shift=shift % tile)
            assert (writes == 1).all()
            plain = segsum_ref(t(ids), t(vals), n_seg).numpy()
            keep = (ids >= 0) & (ids < n_seg)
            want = jsegsum_windowed(jnp.asarray(ids[keep]),
                                    jnp.asarray(vals[keep]), n_seg,
                                    block_nnz=64, block_seg=64)
            if (vals == 1).all():
                np.testing.assert_array_equal(got, plain)
                np.testing.assert_array_equal(got, np.asarray(want))
            else:
                np.testing.assert_allclose(got, plain, **SEG_TOL)
                np.testing.assert_allclose(got, np.asarray(want), **SEG_TOL)

    def test_bf16_values(self):
        ids = np.repeat(np.arange(0, 60, 3), 37).astype(np.int32)
        jv = jnp.asarray(np.random.default_rng(3).normal(
            0, 1, ids.size).astype(np.float32)).astype(jnp.bfloat16)
        vals = np.array(jv.astype(jnp.float32))     # the bf16 values, exact
        got, writes = emulate_windowed(ids, vals, 60, 16)
        assert (writes == 1).all()
        want = jsegsum_windowed(jnp.asarray(ids), jv, 60, block_nnz=64,
                                block_seg=64)
        np.testing.assert_allclose(got, np.asarray(want), **BF16_TOL)
        tv = torch.from_numpy(vals).to(torch.bfloat16)
        np.testing.assert_allclose(got, segsum_ref(t(ids), tv, 60).numpy(),
                                   **SEG_TOL)

    @pytest.mark.parametrize("name,ids,n_seg,tile", WINDOWED_CASES[:5],
                             ids=[c[0] for c in WINDOWED_CASES[:5]])
    def test_range_order_does_not_matter(self, name, ids, n_seg, tile):
        rng = np.random.default_rng(7)
        vals = rng.normal(0, 1, ids.size).astype(np.float32)
        ref, _ = emulate_windowed(ids, vals, n_seg, tile)
        n_ranges = -(-ids.size // tile)
        for _ in range(4):
            got, _ = emulate_windowed(ids, vals, n_seg, tile,
                                      order=rng.permutation(n_ranges))
            assert got.tobytes() == ref.tobytes()

    @settings(max_examples=60, deadline=None)
    @given(runs=st.lists(st.tuples(st.integers(-2, 40), st.integers(1, 30)),
                         min_size=1, max_size=25),
           tile=st.sampled_from([1, 2, 3, 8, 32]),
           n_seg=st.integers(1, 41), shift=st.integers(0, 7))
    def test_property_unit_counts(self, runs, tile, n_seg, shift):
        ids = np.sort(np.repeat([r[0] for r in runs],
                                [r[1] for r in runs])).astype(np.int32)
        ones = np.ones(ids.size, np.float32)
        got, writes = emulate_windowed(ids, ones, n_seg, tile,
                                       shift=shift % tile)
        assert (writes == 1).all()
        np.testing.assert_array_equal(
            got, segsum_ref(t(ids), t(ones), n_seg).numpy())


def emulate_segsum(ids, vals, n_seg, blocks=2, threads=8, slot_bits=4,
                   cache=2, shift=0):
    """numpy model of ``segsum``'s policy in ``csrc/segsum.cu``, at small
    sizes (the kernel: one block of 1024 threads an SM, 2^14 slots, 8
    cached ids a thread).

    Thread g of the grid takes element g if g < ``shift``, then the groups
    of four after ``shift`` in a grid-stride loop, then the rest; the
    block's threads take their elements in turn.  An element goes to its
    thread's cache of ``cache`` ids, else to the block's table (an id
    hashes to one slot; the first id to reach an empty slot claims it),
    else to ``out``.  An element of a claimed id enters the cache,
    evicting the oldest entry into its slot.  At the end the caches are
    summed by id across the block's lanes (as a warp does) into the table
    and the table into ``out``.  Sums are float32."""
    ids = np.asarray(ids, np.int64)
    vals = np.asarray(vals, np.float32)
    nnz = ids.size
    out = np.zeros(n_seg, np.float32)
    stride = blocks * threads

    def elements(g):
        e = [g] if g < min(shift, nnz) else []
        n4 = max(nnz - shift, 0) // 4
        for j in range(g, n4, stride):
            e += [shift + 4 * j + q for q in range(4)]
        rest = shift + 4 * n4 if nnz > shift else nnz
        return e + list(range(rest + g, nnz, stride))

    def slot(x):
        return ((x * 2654435761) & 0xffffffff) >> (32 - slot_bits)

    for b in range(blocks):
        owner, table = {}, np.zeros(1 << slot_bits, np.float32)
        cid = [[None] * cache for _ in range(threads)]
        csum = [[np.float32(0)] * cache for _ in range(threads)]
        nxt = [0] * threads
        streams = [elements(b * threads + t) for t in range(threads)]
        for step in range(max(map(len, streams))):
            for t, stream in enumerate(streams):
                if step >= len(stream):
                    continue
                x, v = int(ids[stream[step]]), vals[stream[step]]
                if not 0 <= x < n_seg:
                    continue
                if x in cid[t]:
                    c = cid[t].index(x)
                    csum[t][c] = np.float32(csum[t][c] + v)
                    continue
                if owner.setdefault(slot(x), x) != x:
                    out[x] = np.float32(out[x] + v)
                    continue
                c, old = nxt[t], cid[t][nxt[t]]
                if old is not None:
                    table[slot(old)] = np.float32(table[slot(old)]
                                                  + csum[t][c])
                cid[t][c], csum[t][c] = x, v
                nxt[t] = (c + 1) % cache
        for c in range(cache):
            groups: dict = {}
            for t in range(threads):
                if cid[t][c] is not None:
                    groups[cid[t][c]] = np.float32(
                        groups.get(cid[t][c], np.float32(0)) + csum[t][c])
            for x, g in groups.items():
                table[slot(x)] = np.float32(table[slot(x)] + g)
        for sl, x in owner.items():
            out[x] = np.float32(out[x] + table[sl])
    return out


def hot_ids(n, n_seg, share, seed):
    """Shuffled ids where one id holds ``share`` of them."""
    rng = np.random.default_rng(seed)
    ids = np.where(rng.random(n) < share, 3, rng.integers(0, n_seg, n))
    return rng.permutation(ids).astype(np.int32)


class TestSegsumEmulation:
    """The scatter kernel's policy (register caches, claimed slots, global
    adds) against the plain version and the Pallas kernel: unit values
    count exactly, other values within SEG_TOL."""

    @pytest.mark.parametrize("shift", [0, 3])
    @pytest.mark.parametrize("case", ["hot", "random", "dropped"])
    def test_matches_plain(self, case, shift):
        rng = np.random.default_rng(31)
        if case == "hot":
            ids = hot_ids(3000, 200, 0.9, seed=1)
        elif case == "random":
            ids = rng.integers(0, 500, 2001).astype(np.int32)
        else:
            ids = rng.integers(-3, 130, 1500).astype(np.int32)
            ids[::17] = 10**6
        n_seg = 500 if case == "random" else (200 if case == "hot" else 120)
        ones = np.ones(ids.size, np.float32)
        np.testing.assert_array_equal(
            emulate_segsum(ids, ones, n_seg, shift=shift),
            segsum_ref(t(ids), t(ones), n_seg).numpy())
        vals = rng.normal(0, 1, ids.size).astype(np.float32)
        got = emulate_segsum(ids, vals, n_seg, shift=shift)
        close(t(got), segsum_ref(t(ids), t(vals), n_seg).numpy(), **SEG_TOL)
        keep = (ids >= 0) & (ids < n_seg)
        close(t(got), jsegsum(jnp.asarray(ids[keep]), jnp.asarray(vals[keep]),
                              n_seg, block_nnz=256, block_seg=128), **SEG_TOL)

    def test_bf16_values(self):
        ids = hot_ids(1200, 50, 0.5, seed=2)
        jv = jnp.asarray(np.random.default_rng(3).normal(
            0, 1, ids.size).astype(np.float32)).astype(jnp.bfloat16)
        vals = np.array(jv.astype(jnp.float32))     # the bf16 values, exact
        got = emulate_segsum(ids, vals, 50, threads=4, cache=3)
        close(t(got), jsegsum(jnp.asarray(ids), jv, 50, block_nnz=128,
                              block_seg=64), **BF16_TOL)
        tv = torch.from_numpy(vals).to(torch.bfloat16)
        close(t(got), segsum_ref(t(ids), tv, 50).numpy(), **SEG_TOL)

    @settings(max_examples=40, deadline=None)
    @given(n=st.integers(1, 300), n_seg=st.integers(1, 60),
           share=st.floats(0.0, 1.0), seed=st.integers(0, 2**16),
           shift=st.integers(0, 3), cache=st.integers(1, 4),
           slot_bits=st.integers(1, 5))
    def test_property_unit_counts(self, n, n_seg, share, seed, shift, cache,
                                  slot_bits):
        ids = hot_ids(n, n_seg, share, seed) % n_seg
        ones = np.ones(n, np.float32)
        np.testing.assert_array_equal(
            emulate_segsum(ids, ones, n_seg, shift=shift, cache=cache,
                           slot_bits=slot_bits),
            np.bincount(ids, minlength=n_seg).astype(np.float32))


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
