"""The port's lazy planner and its device lowering against the JAX
package: matvec chains, device sums and ``eval_batch`` SpMM fusion, with
``DEVICE_NNZ_THRESHOLD`` at 1 so every product lowers.

Both packages see the same table contents; launch counts must agree
(one ``spmm`` per factor for a fused batch), and so must results.
Tolerance: rtol=1e-5, atol=1e-6 on device-lowered floats.
"""
import numpy as np
import pytest

from repro.core import Assoc as JAssoc
from repro.core import eval_batch as jeval_batch
from repro.core import expr as JX
from repro.core import lazy as jlazy
from repro.db import DB as JDB
from repro.db import put as jput
from repro_torch.core import Assoc, eval_batch, lazy
from repro_torch.core import expr as X
from repro_torch.db import DB, put
from repro_torch.device import set_device
from repro_torch.kernels import ops

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    prev = set_device("cpu")
    monkeypatch.setattr(X, "DEVICE_NNZ_THRESHOLD", 1)
    monkeypatch.setattr(JX, "DEVICE_NNZ_THRESHOLD", 1)
    yield
    set_device(prev)


def graph_triples(n=200, nnz=2000, seed=1, weighted=False):
    rng = np.random.default_rng(seed)
    rows = np.asarray([f"v{i:04d}" for i in rng.integers(0, n, nnz)])
    cols = np.asarray([f"v{i:04d}" for i in rng.integers(0, n, nnz)])
    vals = rng.integers(1, 5, nnz).astype(np.float64) if weighted \
        else np.ones(nnz)
    return rows, cols, vals


def tables(weighted=False):
    r, c, v = graph_triples(weighted=weighted)
    T, JT = DB("Tedge", "TedgeT"), JDB("Tedge", "TedgeT")
    put(T, Assoc(r, c, v))
    jput(JT, JAssoc(r, c, v))
    return T, JT


def seed_vecs(j, w=1.0):
    args = (np.asarray([f"v{j:04d}", f"v{j + 7:04d}"]),
            np.asarray([f"seed{j}"] * 2), np.asarray([w, 2.0]))
    return Assoc(*args), JAssoc(*args)


def assert_assoc_close(a, ja):
    np.testing.assert_array_equal(a.row, ja.row)
    np.testing.assert_array_equal(a.col, ja.col)
    r, c, v = a.triples()
    jr, jc, jv = ja.triples()
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_allclose(np.asarray(v, np.float64),
                               np.asarray(jv, np.float64),
                               rtol=RTOL, atol=ATOL)


def delta(before, after):
    return {k: after[k] - before[k] for k in before}


class TestLowering:
    def test_batch_one_spmm_launch(self):
        T, JT = tables(weighted=True)
        vs = [seed_vecs(j, w=0.5 + j) for j in range(8)]
        c0, j0, k0 = X.launch_counts(), JX.launch_counts(), \
            ops.kernel_launches()
        got = eval_batch([T.lazy() * lazy(v) for v, _ in vs])
        want = jeval_batch([JT.lazy() * jlazy(jv) for _, jv in vs])
        d, jd = delta(c0, X.launch_counts()), delta(j0, JX.launch_counts())
        assert d == jd == {"spmv": 0, "spmm": 1}
        # CPU tensors run the plain versions: no kernel launch counted
        assert ops.kernel_launches() == k0
        for g, w in zip(got, want):
            assert_assoc_close(g, w)

    def test_two_factor_batch_two_launches(self):
        T, JT = tables()
        vs = [seed_vecs(j) for j in range(4)]
        c0, j0 = X.launch_counts(), JX.launch_counts()
        got = eval_batch([T.lazy() * T.lazy() * lazy(v) for v, _ in vs])
        want = jeval_batch([JT.lazy() * JT.lazy() * jlazy(jv)
                            for _, jv in vs])
        assert delta(c0, X.launch_counts()) == \
            delta(j0, JX.launch_counts()) == {"spmv": 0, "spmm": 2}
        for g, w in zip(got, want):
            assert_assoc_close(g, w)

    def test_solo_chains_and_sums(self):
        T, JT = tables(weighted=True)
        v, jv = seed_vecs(3)
        c0, j0 = X.launch_counts(), JX.launch_counts()
        assert_assoc_close((T.lazy() * lazy(v)).eval(),
                           (JT.lazy() * jlazy(jv)).eval())
        assert_assoc_close((T.lazy() * T.lazy() * T.lazy() * lazy(v)).eval(),
                           (JT.lazy() * JT.lazy() * JT.lazy()
                            * jlazy(jv)).eval())
        assert delta(c0, X.launch_counts()) == \
            delta(j0, JX.launch_counts()) == {"spmv": 4, "spmm": 0}
        for axis in (0, 1):
            assert_assoc_close(T.lazy().sum(axis).eval(),
                               JT.lazy().sum(axis).eval())

    def test_kernel_path_matches_reference_pallas(self, monkeypatch):
        """Against the reference's own kernel route (interpret mode)."""
        monkeypatch.setattr(JX, "USE_PALLAS_SPMV", True)
        T, JT = tables()
        vs = [seed_vecs(j) for j in range(3)]
        got = eval_batch([T.lazy() * lazy(v) for v, _ in vs])
        want = jeval_batch([JT.lazy() * jlazy(jv) for _, jv in vs])
        for g, w in zip(got, want):
            assert_assoc_close(g, w)


def matrix_tail(A):
    """A two-column tail: its product is no matvec."""
    return A(np.asarray(["v0003", "v0010", "v0010"]),
             np.asarray(["m0", "m0", "m1"]), np.asarray([1.0, 2.0, 3.0]))


# case -> (threshold: "table" for the table's nnz, members built from
# (table, lazy, Assoc), launch delta, the top-level matmul routes)
EDGES = {
    # the factor holds the threshold, its part over the vector's keys
    # does not: the two-part route tests the aligned part
    "aligned_below_threshold": (
        "table", lambda t, lz, A: [t.lazy() * lz(A(
            np.asarray(["v0003", "v0010"]), np.asarray(["s", "s"]),
            np.asarray([1.0, 2.0])))],
        {"spmv": 0, "spmm": 0}, ["host"]),
    # an empty vector: the chain falls back to pairwise host products
    "empty_vector_chain": (
        1, lambda t, lz, A: [t.lazy() * t.lazy() * lz(A(
            np.asarray(["v0003"]), np.asarray(["s"]), np.asarray([0.0])))],
        {"spmv": 0, "spmm": 0}, ["host"]),
    # the last factor shares no key with the vector: it launches
    # nothing, the first factor multiplies zeros
    "disjoint_last_factor": (
        1, lambda t, lz, A: [t.lazy() * t.lazy() * lz(A(
            np.asarray(["w0001", "w0002"]), np.asarray(["s", "s"]),
            np.asarray([1.0, 2.0])))],
        {"spmv": 1, "spmm": 0}, ["chain"]),
    # a non-vector tail in the batch: the vector members fuse into one
    # spmm, the matrix member runs on its own on the host
    "batch_with_matrix_tail": (
        1, lambda t, lz, A: [t.lazy() * lz(A(
            np.asarray([f"v{j:04d}", f"v{j + 7:04d}"]),
            np.asarray([f"seed{j}"] * 2), np.asarray([1.0 + j, 2.0])))
            for j in range(3)] + [t.lazy() * lz(matrix_tail(A))],
        {"spmv": 0, "spmm": 1}, ["host"]),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_lowering_edges(case, monkeypatch):
    """Where a product leaves the device path, or takes it with nothing
    to multiply: answers, launch counts and routes against the JAX
    package's."""
    from repro_torch.obs import Tracer

    threshold, build, launches, routes = EDGES[case]
    if threshold == "table":
        threshold = Assoc(*graph_triples()).nnz
    monkeypatch.setattr(X, "DEVICE_NNZ_THRESHOLD", threshold)
    monkeypatch.setattr(JX, "DEVICE_NNZ_THRESHOLD", threshold)
    T, JT = tables()
    members = build(T, lazy, Assoc)
    jmembers = build(JT, jlazy, JAssoc)
    c0, j0 = X.launch_counts(), JX.launch_counts()
    tr = Tracer(max_spans=4096)
    root = tr.start("q")
    with root:
        got = eval_batch(members)
    want = jeval_batch(jmembers)
    assert delta(c0, X.launch_counts()) == \
        delta(j0, JX.launch_counts()) == launches
    spans = tr.spans(root.trace_id)
    (batch,) = [s for s in spans if s["name"] == "planner.eval_batch"]
    assert [s["tags"]["route"] for s in spans
            if s["name"] == "planner.exec.matmul"
            and s["parent_id"] == batch["span_id"]] == routes
    for g, w in zip(got, want):
        assert_assoc_close(g, w)


def test_planner_pushdown_and_cse_match():
    T, JT = tables()
    e = (T[:, "v0001,v0002,"].logical() > 0) * 2.0
    je = (JT[:, "v0001,v0002,"].logical() > 0) * 2.0
    assert e._plan_str().replace("repro_torch", "repro") == \
        je._plan_str().replace("repro_torch", "repro")
    assert_assoc_close(e.eval(), je.eval())
    cols0, jcols0 = T.stats["col"], JT.stats["col"]
    a, b = eval_batch([T[:, "v0003,"], T[:, "v0003,"]])
    ja, _ = jeval_batch([JT[:, "v0003,"], JT[:, "v0003,"]])
    assert a == b
    assert_assoc_close(a, ja)
    assert T.stats["col"] - cols0 == JT.stats["col"] - jcols0 == 1


def packet_tables(n=300, hosts=10, seed=4):
    """Both packages' stores over one categorical incidence array in the
    pipeline's layout (a packet a row, ``field|value`` columns holding
    the string "1")."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        fields = (f"ip.src|10.0.0.{rng.integers(hosts)}",
                  f"ip.dst|10.0.1.{rng.integers(hosts)}",
                  f"frame.time|{i // 30:04d}")
        rows.extend([f"pkt{i:05d}"] * len(fields))
        cols.extend(fields)
    args = (np.asarray(rows), np.asarray(cols), "1,")
    T, JT = DB("Tedge", "TedgeT"), JDB("Tedge", "TedgeT")
    put(T, Assoc(*args))
    jput(JT, JAssoc(*args))
    return T, JT


@pytest.mark.parametrize("shape,path,counts", [
    ("c2_product", "same", {"same": 1}),
    ("one_host_chain", "search", {"search": 1}),
    ("band_plus_empty", None, {"empty": 2, "same": 1}),
])
def test_alignment_paths_counted_and_tagged(shape, path, counts):
    """The analyst's three alignment shapes take the aligner's paths,
    count them in ``repro_key_align_total`` and tag the product's
    ``planner.exec.align`` span; answers equal the JAX package's."""
    from repro_torch.core import keys
    from repro_torch.core.keys import StartsWith
    from repro.core.keys import StartsWith as JStartsWith
    from repro_torch.obs import Tracer

    T, JT = packet_tables()
    h = "10.0.1.3"
    build = {
        "c2_product": lambda t, sw, lz, A: (t[:, sw("ip.src|")].T
                                            * t[:, sw("ip.dst|")]),
        "one_host_chain": lambda t, sw, lz, A: t.lazy() * lz(A(
            np.asarray([f"ip.dst|{h}", f"ip.src|{h}"]), np.asarray([h, h]),
            np.ones(2))),
        # pagerank's adjacency: the select pushed through the add
        # leaves the src band plus an empty select of the dst band
        "band_plus_empty": lambda t, sw, lz, A: (
            t[:, sw("ip.src|")] + t[:, sw("ip.dst|")])[:, sw("ip.src|")],
    }[shape]
    expr = build(T, StartsWith, lazy, Assoc)
    want = build(JT, JStartsWith, jlazy, JAssoc).eval()
    tr = Tracer(max_spans=4096)
    root = tr.start("q")
    before = keys.align_counts()
    with root:
        got = expr.eval()
    after = keys.align_counts()
    assert {p: after[p] - before[p] for p in after
            if after[p] != before[p]} == counts
    tags = [s["tags"].get("path") for s in tr.spans(root.trace_id)
            if s["name"] == "planner.exec.align"]
    assert tags == ([] if path is None else [path])
    assert_assoc_close(got, want)
    if shape == "band_plus_empty":
        np.testing.assert_array_equal(got.val, want.val)
