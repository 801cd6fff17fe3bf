"""The whole ported slice against the JAX package on one small window:
ingest through the DB binding, the TedgeDeg power-law fit, the C2 and
scan detectors, a fused ``eval_batch`` of matvec chains and PageRank —
plus the device graph and analytics functions they stand on.

Host results must match exactly; device floats within rtol=1e-5,
atol=1e-6 (fp32 in both, summed in another order).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analytics as janalytics
from repro.core import Assoc as JAssoc
from repro.core import eval_batch as jeval_batch
from repro.core import expr as JX
from repro.core import graph as jgraph
from repro.core import lazy as jlazy
from repro.core import parse_tsv as jparse_tsv
from repro.core import sparse as jS
from repro.core import val2col as jval2col
from repro.db import DB as JDB
from repro.db import put as jput
from repro_torch import analytics
from repro_torch.core import Assoc, eval_batch, graph, lazy, parse_tsv, \
    val2col
from repro_torch.core import expr as X
from repro_torch.core.interop import coo_from_numpy
from repro_torch.db import DB, put
from repro_torch.device import set_device
from repro_torch.pipeline import TrafficConfig, botnet_truth, \
    records_to_tsv, synth_packets

RTOL, ATOL = 1e-5, 1e-6
CFG = dict(n_hosts=64, pkt_rate=300.0, n_bots=8, beacon_period_s=4.0, seed=1)


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def window_records():
    return synth_packets(TrafficConfig(**CFG), 30.0)


@pytest.fixture(scope="module")
def window():
    """One 30 s window ingested into both packages' memory backends."""
    prev = set_device("cpu")
    text = records_to_tsv(window_records())
    T = DB("Tedge", "TedgeT", "TedgeDeg", n_instances=2,
           tablets_per_instance=4)
    JT = JDB("Tedge", "TedgeT", "TedgeDeg", n_instances=2,
             tablets_per_instance=4)
    put(T, val2col(parse_tsv(text)).putval("1,"))
    jput(JT, jval2col(jparse_tsv(text)).putval("1,"))
    T.flush()
    JT.flush()
    set_device(prev)
    return T, JT


def close(a, b):
    np.testing.assert_allclose(np.asarray(a.cpu() if torch.is_tensor(a)
                                          else a, np.float64),
                               np.asarray(b, np.float64),
                               rtol=RTOL, atol=ATOL)


def assert_assoc_equal(a, ja):
    np.testing.assert_array_equal(a.row, ja.row)
    np.testing.assert_array_equal(a.col, ja.col)
    for x, y in zip(a.triples(), ja.triples()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestSlice:
    def test_ingest_same_tables(self, window):
        T, JT = window
        assert T.n_entries == JT.n_entries > 0
        assert_assoc_equal(T[:, "ip.dst|*,"].eval(), JT[:, "ip.dst|*,"].eval())
        assert_assoc_equal(T.degree_assoc("ip.src|"),
                           JT.degree_assoc("ip.src|"))

    def test_powerlaw_fit(self, window):
        T, JT = window
        fit, jfit = analytics.fit_degree_table(T, "ip.dst|"), \
            janalytics.fit_degree_table(JT, "ip.dst|")
        for f in ("alpha", "log_c", "r2"):
            close(getattr(fit, f), getattr(jfit, f))
        # resid = log(d) - model: a difference of fp32 terms of size up to
        # log(max degree), so its absolute error scales with that size
        scale = float(np.log(T.degree_assoc("ip.dst|").triples()[2].max()))
        np.testing.assert_allclose(fit.resid.numpy(), np.asarray(jfit.resid),
                                   rtol=RTOL, atol=ATOL * scale)
        assert json.loads(fit.to_json())["alpha"] == \
            pytest.approx(float(jfit.alpha), rel=RTOL)

    def test_c2_report(self, window):
        T, JT = window
        rep, jrep = analytics.detect_c2(T, top_k=8), \
            janalytics.detect_c2(JT, top_k=8)
        np.testing.assert_array_equal(rep.hosts, jrep.hosts)
        assert botnet_truth(TrafficConfig(**CFG))["c2"] in rep.hosts[:3]
        for f in ("fanin", "regularity", "port_conc"):
            np.testing.assert_array_equal(getattr(rep, f), getattr(jrep, f))
        close(rep.scores, jrep.scores)
        assert rep.to_dict()["hosts"] == jrep.to_dict()["hosts"]

    def test_scan_detect(self):
        """A scanner (one packet to each of 40 hosts) injected into the
        head of the window, queried as an in-memory incidence Assoc."""
        rec = window_records()[:400]
        scan = rec[:40].copy()
        scan["src"] = 0x09090909
        scan["dst"] = 0x0A000000 + np.arange(40, dtype=np.uint32)
        text = records_to_tsv(np.concatenate([rec, scan]))
        E, jE = val2col(parse_tsv(text)), jval2col(jparse_tsv(text))
        hits = analytics.scan_detect(E, min_fanout=32)
        np.testing.assert_array_equal(hits, janalytics.scan_detect(
            jE, min_fanout=32))
        assert list(hits) == ["9.9.9.9"]
        assert analytics.scan_report(E).to_dict() == \
            janalytics.scan_report(jE).to_dict()

    def test_fused_batch(self, window):
        T, JT = window
        hosts = analytics.detect_c2(T, top_k=8).hosts

        def ind(cls, h):
            return cls(np.asarray([f"ip.dst|{h}", f"ip.src|{h}"]),
                       np.asarray([h, h]), np.ones(2))

        c0, j0 = X.launch_counts(), JX.launch_counts()
        got = eval_batch([T.lazy() * lazy(ind(Assoc, h)) for h in hosts])
        want = jeval_batch([JT.lazy() * jlazy(ind(JAssoc, h))
                            for h in hosts])
        d = {k: X.launch_counts()[k] - c0[k] for k in c0}
        jd = {k: JX.launch_counts()[k] - j0[k] for k in j0}
        assert d == jd == {"spmv": 0, "spmm": 1}
        for g, w in zip(got, want):
            assert_assoc_equal(g, w)

    def test_pagerank_table(self, window):
        T, JT = window
        keys, pr = analytics.distributed.pagerank_table(T, num_iters=6)
        jkeys, jpr = janalytics.distributed.pagerank_table(JT, num_iters=6)
        np.testing.assert_array_equal(keys, jkeys)
        close(pr, jpr)
        seed = {keys[0]: 1.0}
        _, ppr = analytics.distributed.pagerank_table(
            T, num_iters=3, personalize=seed, reverse=True)
        _, jppr = janalytics.distributed.pagerank_table(
            JT, num_iters=3, personalize=seed, reverse=True)
        close(ppr, jppr)

    def test_backends_not_ported_raise(self):
        """``"net"`` is ported: it opens on the CPU with its own local
        shard servers and closes them again.  ``"lsm"``, like the
        reference, still refuses to open without a directory."""
        from repro_torch.db import NetMultiInstanceDB
        T = DB("Tedge", "TedgeT", "TedgeDeg", backend="net", n_instances=2)
        try:
            assert isinstance(T.backend, NetMultiInstanceDB)
            assert len(T.backend.servers) == 2
            assert all(i.ping() for i in T.backend.instances)
        finally:
            T.close()
            T.backend.close()
        with pytest.raises(ConnectionError):
            T.backend.instances[0].ping()
        with pytest.raises(ValueError, match="requires path"):
            DB("Tedge", backend="lsm")


def adjacency_case(seed=0, n=30, nnz=150):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n * n, nnz))
    rows, cols = (key // n).astype(np.int32), (key % n).astype(np.int32)
    vals = rng.integers(1, 4, key.shape[0]).astype(np.float32)
    return rows, cols, vals, (n, n)


class TestDeviceAnalytics:
    def test_graph_functions(self):
        r, c, v, shape = adjacency_case()
        m = coo_from_numpy(r, c, v, shape)
        jm = jS.COO(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), shape)
        close(graph.pagerank(m, num_iters=25), jgraph.pagerank(jm, 25))
        probe = np.random.default_rng(1).choice([-1.0, 1.0], (30, 4)) \
            .astype(np.float32)
        close(graph.triangle_count(m, torch.from_numpy(probe)),
              jgraph.triangle_count(jm, jnp.asarray(probe)))
        for a, b in zip(graph.degree_counts(m), jgraph.degree_counts(jm)):
            close(a, b)
        seed = np.zeros(30, np.float32)
        seed[[0, 5]] = 1
        np.testing.assert_array_equal(
            graph.bfs_reachable(m, torch.from_numpy(seed), hops=2).numpy(),
            np.asarray(jgraph.bfs_reachable(jm, jnp.asarray(seed), hops=2)))

    def test_powerlaw_functions(self):
        d = np.random.default_rng(2).pareto(1.5, 200).astype(np.float32)
        d[::17] = 0
        close(analytics.background_scores(torch.from_numpy(d)),
              janalytics.background_scores(jnp.asarray(d)))
        centers, counts = analytics.degree_histogram(torch.from_numpy(d), 16)
        jcenters, jcounts = janalytics.degree_histogram(jnp.asarray(d), 16)
        close(centers, jcenters)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))

    def test_sharded_helpers(self):
        r, c, v, shape = adjacency_case(seed=4)
        m = coo_from_numpy(r, c, v, shape)
        jm = jS.COO(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), shape)
        D, jD = analytics.distributed, janalytics.distributed
        sh, jsh = D.shard_coo(m, 3), jD.shard_coo(jm, 3)
        np.testing.assert_array_equal(sh.rows.numpy(), np.asarray(jsh.rows))
        import jax
        from jax.sharding import Mesh
        mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
        close(D.degree_sharded(m), jD.degree_sharded(jm, mesh))
        close(D.spmv_weighted_rowsum(m), jD.spmv_weighted_rowsum(jm, mesh))
        x = np.random.default_rng(5).random(30).astype(np.float32)
        close(D.spmv_t_sharded(m, torch.from_numpy(x)),
              jD.spmv_t_sharded(jm, jnp.asarray(x), mesh))

    def test_serialize_coerces_tensors(self):
        out = analytics.to_jsonable({"a": torch.tensor([1.5, 2.0]),
                                     "b": torch.tensor(3),
                                     "c": np.float32(0.5)})
        assert out == {"a": [1.5, 2.0], "b": 3, "c": 0.5}
