"""Semiring, sparse and host-algebra modules of the PyTorch port against
the JAX package, on identical numpy inputs.

Host algebra (keys, Assoc, schema) must match exactly; device floats
within rtol=1e-5, atol=1e-6 (fp32 in both, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import keys as jkeys
from repro.core import semiring as jsr
from repro.core import sparse as jS
from repro.core.assoc import Assoc as JAssoc
from repro.core.schema import parse_tsv as jparse_tsv
from repro.core.schema import val2col as jval2col
from repro.pipeline.pcap import TrafficConfig as JTrafficConfig
from repro.pipeline.pcap import records_to_tsv as jrecords_to_tsv
from repro.pipeline.pcap import synth_packets as jsynth_packets
from repro_torch.core import keys, semiring as sr, sparse as S
from repro_torch.core.assoc import Assoc
from repro_torch.core.interop import (assoc_from_parts, coo_from_numpy,
                                      ell_from_numpy)
from repro_torch.core.schema import col2val, parse_tsv, val2col
from repro_torch.device import get_device, set_device
from repro_torch.pipeline.pcap import (TrafficConfig, records_to_tsv,
                                       synth_packets)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def random_coo(n_rows=40, n_cols=30, nnz=200, seed=0, dead=0):
    """Sorted coalesced triples, plus ``dead`` slots parked at
    ``row == n_rows`` (value 0) as the in-place coalesce leaves them."""
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_rows * n_cols, nnz))
    rows = (key // n_cols).astype(np.int32)
    cols = (key % n_cols).astype(np.int32)
    vals = rng.normal(0, 1, key.shape[0]).astype(np.float32)
    if dead:
        rows = np.concatenate([rows, np.full(dead, n_rows, np.int32)])
        cols = np.concatenate([cols, np.zeros(dead, np.int32)])
        vals = np.concatenate([vals, np.zeros(dead, np.float32)])
    return rows, cols, vals, (n_rows, n_cols)


def both(rows, cols, vals, shape):
    jm = jS.COO(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                shape)
    return jm, coo_from_numpy(rows, cols, vals, shape)


class TestSemiring:
    @pytest.mark.parametrize("name", sorted(jsr.REGISTRY))
    def test_reduce_matches_jax(self, name):
        """Empty segments stay at ±inf for max/min (not the semiring's
        zero) and ids == num_segments are dropped, as in JAX."""
        rng = np.random.default_rng(len(name))
        n_seg = 12
        ids = rng.integers(0, n_seg - 3, 100).astype(np.int32)  # 3 empty
        ids[::7] = n_seg                                         # dead slots
        data = rng.normal(0, 1, 100).astype(np.float32)
        want = np.asarray(jsr.get(name).reduce(jnp.asarray(data),
                                               jnp.asarray(ids), n_seg))
        got = sr.get(name).reduce(torch.from_numpy(data),
                                  torch.from_numpy(ids), n_seg).numpy()
        assert np.array_equal(np.isinf(got), np.isinf(want))
        assert np.isinf(got[-3:]).all() or name == "plus_times"
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("name", sorted(jsr.REGISTRY))
    def test_identities_and_elementwise(self, name):
        a = np.asarray([0., 1.5, -2., 3.], np.float32)
        b = np.asarray([2., 0., -1., 3.], np.float32)
        j, p = jsr.get(name), sr.get(name)
        assert (p.zero, p.one) == (j.zero, j.one)
        np.testing.assert_array_equal(
            p.mul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
            np.asarray(j.mul(jnp.asarray(a), jnp.asarray(b))))
        np.testing.assert_array_equal(
            p.add(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
            np.asarray(j.add(jnp.asarray(a), jnp.asarray(b))))

    def test_unknown_ring(self):
        with pytest.raises(KeyError):
            sr.get("nope")


class TestSparse:
    @pytest.mark.parametrize("ring", ["plus_times", "max_times", "min_plus",
                                      "or_and"])
    def test_spmv_spmv_t_spmm(self, ring):
        jm, m = both(*random_coo(seed=1, dead=5))
        rng = np.random.default_rng(2)
        x = rng.normal(0, 1, 30).astype(np.float32)
        xr = rng.normal(0, 1, 40).astype(np.float32)
        X = rng.normal(0, 1, (30, 4)).astype(np.float32)
        close(S.spmv(m, torch.from_numpy(x), ring),
              jS.spmv(jm, jnp.asarray(x), ring))
        close(S.spmv_t(m, torch.from_numpy(xr), ring),
              jS.spmv_t(jm, jnp.asarray(xr), ring))
        close(S.spmm(m, torch.from_numpy(X), ring),
              jS.spmm(jm, jnp.asarray(X), ring))

    @pytest.mark.parametrize("weighted", [False, True])
    def test_degrees_drop_dead_slots(self, weighted):
        jm, m = both(*random_coo(seed=3, dead=7))
        close(S.row_degree(m, weighted), jS.row_degree(jm, weighted))
        close(S.col_degree(m, weighted), jS.col_degree(jm, weighted))

    def test_transpose_csr_roundtrip_dense(self):
        jm, m = both(*random_coo(seed=4))
        jt, pt = jS.transpose(jm), S.transpose(m)
        for a, b in [(pt.rows, jt.rows), (pt.cols, jt.cols),
                     (pt.vals, jt.vals)]:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert pt.shape == jt.shape
        csr, jcsr = S.coo_to_csr(m), jS.coo_to_csr(jm)
        np.testing.assert_array_equal(csr.row_ptr.numpy(),
                                      np.asarray(jcsr.row_ptr))
        back = S.csr_to_coo(csr)
        np.testing.assert_array_equal(back.rows.numpy(), m.rows.numpy())
        close(m.to_dense(), jm.to_dense())
        assert (m.to_scipy() != jm.to_scipy()).nnz == 0

    def test_coalesce_parks_dead_slots(self):
        rows = np.asarray([2, 0, 2, 1, 0, 2], np.int32)
        cols = np.asarray([1, 3, 1, 0, 3, 2], np.int32)
        vals = np.asarray([1., 2., 3., 4., 5., 6.], np.float32)
        jm, m = both(rows, cols, vals, (3, 4))
        jc, c = jS.coalesce(jm), S.coalesce(m)
        for a, b in [(c.rows, jc.rows), (c.cols, jc.cols),
                     (c.vals, jc.vals)]:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int((c.rows == 3).sum()) == 2          # two duplicates died
        close(S.row_degree(c, True), jS.row_degree(jc, True))

    def test_from_numpy_and_scipy_bridge(self):
        rng = np.random.default_rng(6)
        r = rng.integers(0, 9, 60)
        c = rng.integers(0, 7, 60)
        v = rng.normal(0, 1, 60)
        m, jm = S.COO.from_numpy(r, c, v, (9, 7)), \
            jS.COO.from_numpy(r, c, v, (9, 7))
        np.testing.assert_array_equal(m.rows.numpy(), np.asarray(jm.rows))
        assert m.vals.dtype == torch.float32          # 32-bit on device
        close(m.vals, jm.vals)
        sm = S.scipy_from_triples(r, c, v, (9, 7))
        assert (sm != jS.scipy_from_triples(r, c, v, (9, 7))).nnz == 0
        p, j = S.coo_from_scipy(sm), jS.coo_from_scipy(sm)
        np.testing.assert_array_equal(p.cols.numpy(), np.asarray(j.cols))
        close(p.vals, j.vals)
        assert p.device == get_device()

    def test_interop_ell(self):
        ec, ev = ell_from_numpy(np.asarray([[0, -1]]), np.asarray([[2., 0.]]))
        assert ec.dtype == torch.int32 and ev.dtype == torch.float32


def small_window(n_packets_s=60.0):
    cfg = dict(n_hosts=32, pkt_rate=5.0, n_bots=4, beacon_period_s=4.0,
               seed=5)
    rec = synth_packets(TrafficConfig(**cfg), n_packets_s)
    jrec = jsynth_packets(JTrafficConfig(**cfg), n_packets_s)
    assert rec.tobytes() == jrec.tobytes()
    text = records_to_tsv(rec)
    assert text == jrecords_to_tsv(jrec)
    return text


def assert_assoc_equal(a, ja):
    np.testing.assert_array_equal(a.row, ja.row)
    np.testing.assert_array_equal(a.col, ja.col)
    r, c, v = a.triples()
    jr, jc, jv = ja.triples()
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(np.asarray(v), np.asarray(jv))


class TestHostAlgebra:
    def test_schema_window_exact(self):
        text = small_window()
        dense, jdense = parse_tsv(text), jparse_tsv(text)
        assert_assoc_equal(dense, jdense)
        E, jE = val2col(dense), jval2col(jdense)
        assert_assoc_equal(E, jE)
        assert_assoc_equal(col2val(E), jdense)

    def test_assoc_algebra_exact(self):
        text = small_window()
        E, jE = val2col(parse_tsv(text)), jval2col(jparse_tsv(text))
        sel = keys.StartsWith("ip.dst|")
        jsel = jkeys.StartsWith("ip.dst|")
        assert_assoc_equal(E[:, sel], jE[:, jsel])
        assert_assoc_equal(E.T * E, jE.T * jE)
        assert_assoc_equal(E.sum(0), jE.sum(0))
        assert_assoc_equal((E.logical() + E).putval("1,"),
                           (jE.logical() + jE).putval("1,"))

    def test_device_coo_and_parts(self):
        text = small_window()
        E, jE = val2col(parse_tsv(text)), jval2col(jparse_tsv(text))
        m, jm = E.device_coo(), jE.device_coo()
        np.testing.assert_array_equal(m.rows.numpy(), np.asarray(jm.rows))
        np.testing.assert_array_equal(m.cols.numpy(), np.asarray(jm.cols))
        close(m.vals, jm.vals)
        assert m.shape == jm.shape and m.vals.dtype == torch.float32
        rebuilt = assoc_from_parts(jE.row, jE.col, jE.sm)
        assert_assoc_equal(rebuilt, jE)
        assert isinstance(rebuilt, Assoc) and rebuilt == E

    def test_keys_exact(self):
        text = "b,a,c,a,"
        np.testing.assert_array_equal(keys.parse_keys(text),
                                      jkeys.parse_keys(text))
        d = np.asarray(["a", "ab", "b", "ba", "c"])
        for s, js in [(keys.StartsWith("b"), jkeys.StartsWith("b")),
                      (keys.KeyRange("ab", "ba"), jkeys.KeyRange("ab", "ba")),
                      ("a,c,", "a,c,")]:
            np.testing.assert_array_equal(keys.resolve_selector(s, d),
                                          jkeys.resolve_selector(js, d))

    def test_cross_package_types_stay_apart(self):
        assert not isinstance(JAssoc(), Assoc)


# -- key alignment by index maps ----------------------------------------------

def _dictionary(rng, n, width, prefix="k"):
    """``n`` sorted unique keys of ``width`` digits (fewer on a collision)."""
    return np.unique(np.asarray(
        [f"{prefix}{v:0{width}d}" for v in rng.integers(0, 10 ** width, n)]))


def _align_case(name, rng):
    """(a, b, path taken for "inter", path taken for "union")."""
    a = _dictionary(rng, 3000, 6)
    if name == "equal":
        return a, a.copy(), "same", "same"
    if name == "one_empty":
        return a, a[:0], "empty", "empty"
    if name == "both_empty":
        return a[:0], np.empty(0, "U5"), "same", "same"
    if name == "disjoint":
        return a, _dictionary(rng, 2500, 6, prefix="z"), "merge", "merge"
    if name == "nested":
        return a[rng.random(a.shape[0]) < 0.6], a, "merge", "merge"
    if name == "16_in_10k":
        big = _dictionary(rng, 10000, 7)
        small = np.unique(np.concatenate(
            [rng.choice(big, 12, replace=False), _dictionary(rng, 4, 7, "j")]))
        return big, small, "search", "search"
    assert name == "widths"    # a <U7 dictionary against a <U31 one
    wide = np.asarray([k + "|" + "x" * 24 for k in a[::3]])
    return a, np.unique(np.concatenate([wide, a[1::2]])), "merge", "merge"


def _searched_map(own, target):
    """The projection as it was made before the aligner: each own key
    binary-searched in the target, -1 where absent."""
    if target.shape[0] == 0 or own.shape[0] == 0:
        return np.full(own.shape[0], -1, np.int64)
    pos = np.clip(np.searchsorted(target, own), 0, target.shape[0] - 1)
    return np.where(target[pos] == own, pos, -1).astype(np.int64)


def _searched_onto(A, row, col):
    """``Assoc._onto`` as it was: searched maps, then COO → CSR."""
    import scipy.sparse as sp
    coo = A._numeric_sm().tocoo()
    rr = _searched_map(A.row, row)[coo.row]
    cc = _searched_map(A.col, col)[coo.col]
    m = (rr >= 0) & (cc >= 0)
    return sp.csr_matrix((coo.data[m], (rr[m], cc[m])),
                         shape=(row.shape[0], col.shape[0]))


@pytest.mark.parametrize("case", ["equal", "one_empty", "both_empty",
                                  "disjoint", "nested", "16_in_10k",
                                  "widths"])
def test_align_matches_set_ops_and_searched_projection(case):
    rng = np.random.default_rng(sum(case.encode()))
    a, b, p_inter, p_union = _align_case(case, rng)
    for x, y in ((a, b), (b, a)):
        for how, ref, path in (("inter", np.intersect1d, p_inter),
                               ("union", np.union1d, p_union)):
            before = keys.align_counts()
            al = keys.align(x, y, how)
            want = ref(x, y)
            assert al.path == path
            assert keys.align_counts()[path] == before[path] + 1
            np.testing.assert_array_equal(al.keys, want)
            assert al.keys.dtype == want.dtype
            for own, ix in ((x, al.ia), (y, al.ib)):
                got = np.arange(own.shape[0]) if ix is None else ix
                np.testing.assert_array_equal(got, _searched_map(own, want))
                assert ix is not None or own.shape[0] == want.shape[0]
            # a payload over x's rows and y's columns, onto the alignment
            # of its rows with y and of its columns with x
            if x.shape[0] and y.shape[0]:
                n = 4 * (x.shape[0] + y.shape[0])
                A = Assoc(rng.choice(x, n), rng.choice(y, n),
                          rng.normal(size=n))
            else:
                A = Assoc()
            r, c = keys.align(A.row, y, how), keys.align(A.col, x, how)
            got = A._onto(r.ia, c.ia, (r.keys.shape[0], c.keys.shape[0]))
            want_sm = _searched_onto(A, r.keys, c.keys)
            assert got.shape == want_sm.shape and got.has_canonical_format
            for f in ("indptr", "indices", "data"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want_sm, f))
                assert getattr(got, f).dtype == getattr(want_sm, f).dtype


def _categorical(rng, n, n_rows, n_cols, vals):
    rows = np.asarray([f"p{i:04d}" for i in rng.integers(0, n_rows, n)])
    cols = np.asarray([f"f|{i}" for i in rng.integers(0, n_cols, n)])
    return rows, cols, np.asarray(rng.choice(vals, n))


@pytest.mark.parametrize("case", ["band_plus_empty", "overlap",
                                  "other_values", "both_empty"])
def test_categorical_add_matches_reference(case):
    """Union-add of two categorical arrays (the smaller string wins on a
    shared entry) against the JAX package's triple rebuild."""
    rng = np.random.default_rng(len(case))
    x = _categorical(rng, 400, 120, 30, ["1", "2", "b"])
    y = {"band_plus_empty": x, "both_empty": x,
         "overlap": _categorical(rng, 300, 150, 40, ["1", "0", "bb"]),
         "other_values": _categorical(rng, 200, 80, 20, ["zz", "a"])}[case]
    A, B, JA, JB = Assoc(*x), Assoc(*y), JAssoc(*x), JAssoc(*y)
    if case in ("band_plus_empty", "both_empty"):
        B, JB = B[:, "g|*,"], JB[:, "g|*,"]     # no such column: empty
    if case == "both_empty":
        A, JA = A[:, "g|*,"], JA[:, "g|*,"]
    for got, want in ((A + B, JA + JB), (B + A, JB + JA)):
        assert_assoc_equal(got, want)
        assert (got.val is None) == (want.val is None)
        if got.val is not None:
            np.testing.assert_array_equal(got.val, want.val)
        np.testing.assert_array_equal(got.sm.toarray(), want.sm.toarray())
