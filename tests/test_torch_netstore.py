"""The port's networked shard backend (``repro_torch.db.netstore``) against
the JAX package's, on the same triples: scans, degrees, ``connections``
and the binding's ``stats()`` keys must be identical, the two packages'
clients and servers speak one wire format, and killing a shard fails or
recovers the WriterPool exactly as it does for the reference.  All host
code: every comparison is exact.

Shard servers bind port 0 on loopback and stop in teardown; the port's
clients take ``io_timeout=IO`` so a stalled reply fails one test."""
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from _hyp import given, settings, st  # hypothesis, skipping when absent
from repro.db import DB as JDB
from repro.db import EdgeStore as JEdgeStore
from repro.db import NetMultiInstanceDB as JNetMultiInstanceDB
from repro.db import ShardServer as JShardServer
from repro.db import WriterPool as JWriterPool
from repro.db import put as jput
from repro_torch.core.assoc import Assoc
from repro_torch.db import (DB, AsyncWriterError, EdgeStore, LSMStore,
                            MultiInstanceDB, NetMultiInstanceDB, ShardClient,
                            ShardError, ShardServer, WriterPool, put)
from repro_torch.device import set_device
from repro_torch.serve.app import synthetic_incidence
from test_torch_lsmstore import degrees, fill, observe, rand_triples, \
    snapshot

SRC = str(Path(__file__).resolve().parents[1] / "src")
IO = 10.0               # seconds a shard may take to answer one frame


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


@pytest.fixture
def pair():
    """Three memory-backed local shards for each package; torn down."""
    p = NetMultiInstanceDB(n_instances=3, tablets_per_instance=3,
                           io_timeout=IO)
    j = JNetMultiInstanceDB(n_instances=3, tablets_per_instance=3)
    yield p, j
    p.close()
    j.close()


def key_tree(d):
    """The nested key structure of a stats snapshot (values dropped)."""
    if isinstance(d, dict):
        return {k: key_tree(v) for k, v in d.items()}
    return None


def table_answers(T, c2_ip):
    """What a binding answers over one ingested window, as plain values."""
    dst = T[:, "ip.dst|*,"].eval()
    r, _, v = T.degree_assoc("ip.dst|").triples()
    return {
        "n_entries": T.n_entries,
        "dst": [x.tolist() for x in dst.triples()[:2]],
        "row": [x.tolist() for x in
                T["000000001,:,000000040,", :].eval().triples()[:2]],
        "deg": dict(zip(r.tolist(), np.asarray(v, float).tolist())),
        "point": T.degree(f"ip.dst|{c2_ip}"),
        "conn": T.backend.connections(c2_ip),
    }


class TestScanAgreement:
    @pytest.mark.parametrize("seed", range(4))
    def test_same_triples_same_answers(self, pair, seed):
        """Port net, reference net and the port's memory backend answer
        every scan-protocol call alike over the same batched puts."""
        p, j = pair
        mem = MultiInstanceDB(n_instances=3, tablets_per_instance=3)
        r, c, v = rand_triples(seed, n=250)
        for store in (p, j, mem):
            fill(store, r, c, v)
        want = observe(j, r, c)
        assert observe(p, r, c) == want
        assert observe(mem, r, c) == want
        for pi, ji in zip(p.instances, j.instances):    # same placement
            assert snapshot(pi) == snapshot(ji)

    def test_chunked_streaming_covers_full_scan(self):
        db = NetMultiInstanceDB(n_instances=2, chunk_items=16,
                                io_timeout=IO)
        try:
            r, c, v = rand_triples(9, n=400, n_rows=300, n_cols=40)
            db.put_triples(r, c, v)
            keys = [k for k, _ in db.scan_everything()]
            assert keys == sorted(keys)
            assert set(keys) == set(r.tolist())
        finally:
            db.close()

    def test_abandoned_scan_does_not_poison_pool(self, pair):
        p, _ = pair
        r, c, v = rand_triples(3, n=300, n_rows=280)
        p.put_triples(r, c, v)
        it = p.instances[0].scan_everything()
        next(it)
        it.close()
        assert p.instances[0].ping()
        assert snapshot(p)

    def test_put_degree(self):
        srv = ShardServer(EdgeStore(n_tablets=2)).start()
        client = ShardClient(srv.address, io_timeout=IO)
        try:
            client.put_degree(Assoc("ip.dst|a,ip.dst|b,", "degree,degree,",
                                    np.asarray([3.0, 4.0])))
            assert degrees(client) == {"ip.dst|a": 3.0, "ip.dst|b": 4.0}
        finally:
            client.close()
            srv.stop()


class TestWireFormat:
    """One wire format: each package's client against the other's
    server answers as against its own."""

    @pytest.mark.parametrize("server", ["reference", "port"])
    def test_cross_package_client_and_server(self, server):
        r, c, v = rand_triples(11, n=200)
        if server == "reference":
            srv = JShardServer(JEdgeStore(n_tablets=2)).start()
        else:
            srv = ShardServer(EdgeStore(n_tablets=2)).start()
        own = EdgeStore(n_tablets=2)
        fill(own, r, c, v)
        client = ShardClient(srv.address, io_timeout=IO)
        try:
            fill(client, r, c, v)
            assert observe(client, r, c) == observe(own, r, c)
            client.sync()
            with pytest.raises(ShardError, match="unknown op"):
                client._rpc("nope")
        finally:
            client.close()
            srv.stop()

    def test_reference_binding_over_port_shards(self):
        """The JAX package's ``DB(backend="net")`` over the port's shard
        servers reads what the port's binding wrote."""
        servers = [ShardServer(EdgeStore(n_tablets=2)).start()
                   for _ in range(2)]
        addrs = [s.address for s in servers]
        E = synthetic_incidence(seed=5, duration=10.0, n_hosts=32,
                                n_bots=4)
        T = DB("Tedge", "TedgeT", "TedgeDeg", backend="net",
               addresses=addrs, io_timeout=IO)
        J = JDB("Tedge", "TedgeT", "TedgeDeg", backend="net",
                addresses=addrs)
        try:
            put(T, E.putval("1,"))
            T.flush()
            host = str(T.degree_assoc("ip.dst|").triples()[0][0])[7:]
            assert table_answers(T, host) == table_answers(J, host)
        finally:
            for b in (T.backend, J.backend):
                b.close()
            for s in servers:
                s.stop()


class TestBinding:
    def test_net_opens_and_matches_reference_and_memory(self):
        """The same window into the port's net and memory backends and
        the reference's net backend: identical answers, and identical
        ``stats()`` keys between the two net bindings."""
        E = synthetic_incidence(seed=3, duration=20.0, n_hosts=64,
                                n_bots=6)
        from repro.serve.app import synthetic_incidence as jsynth
        JE = jsynth(seed=3, duration=20.0, n_hosts=64, n_bots=6)
        T = DB("Tedge", "TedgeT", "TedgeDeg", backend="net", n_instances=2,
               io_timeout=IO)
        M = DB("Tedge", "TedgeT", "TedgeDeg", n_instances=2)
        J = JDB("Tedge", "TedgeT", "TedgeDeg", backend="net",
                n_instances=2)
        try:
            assert isinstance(T.backend, NetMultiInstanceDB)
            assert len(T.backend.servers) == 2
            put(T, E.putval("1,"), sync=False)
            put(M, E.putval("1,"))
            jput(J, JE.putval("1,"), sync=False)
            T.flush()
            J.flush()
            top = max(T.degree_assoc("ip.dst|").triples()[0],
                      key=lambda k: T.degree(k))[7:]
            want = table_answers(J, top)
            assert table_answers(T, top) == want
            assert table_answers(M, top) == want
            assert key_tree(T.stats()) == key_tree(J.stats())
            s = T.stats()["backend"]
            assert s["kind"] == "NetMultiInstanceDB" and s["n_rpcs"] > 0
        finally:
            T.close()
            T.backend.close()
            J.close()
            J.backend.close()

    def test_registry_errors_and_hash(self):
        with pytest.raises(ValueError, match="engine options"):
            NetMultiInstanceDB(addresses=["127.0.0.1:1"], memtable_limit=5)
        assert NetMultiInstanceDB.key_hash("p1") == zlib.crc32(b"p1") == \
            JNetMultiInstanceDB.key_hash("p1")

    def test_scan_cache_invalidation(self):
        T = DB("Tedge", "TedgeT", "TedgeDeg", backend="net", n_instances=2,
               io_timeout=IO)
        try:
            put(T, Assoc("p1,", "ip.dst|a,", "1,"))
            assert T[:, "ip.dst|*,"].eval().nnz == 1
            T.backend.route("x").put(Assoc("p2,", "ip.dst|a,", "1,"))
            assert T[:, "ip.dst|*,"].eval().nnz == 2
            T.close()
        finally:
            T.backend.close()


class TestFailover:
    @pytest.mark.parametrize("pkg", ["port", "reference"])
    def test_dead_shard_raises_async_writer_error(self, pkg):
        """Kill one shard: blocks routed to it exhaust the retries and
        surface AsyncWriterError naming its address, in both packages."""
        if pkg == "port":
            db, mk = NetMultiInstanceDB(n_instances=2, io_timeout=IO), \
                WriterPool
        else:
            db, mk = JNetMultiInstanceDB(n_instances=2), JWriterPool
        pool = mk(db, max_retries=1, retry_backoff_s=0.01)
        try:
            r, c, v = rand_triples(0, n=40)
            pool.submit(r, c, v)
            pool.flush()
            assert pool.n_written == 40
            dead = db.servers[0]
            dead.stop()
            pool.submit(r, c, v)
            with pytest.raises(Exception, match=dead.address) as ei:
                pool.flush()
            assert type(ei.value).__name__ == "AsyncWriterError"
            if pkg == "port":
                assert isinstance(ei.value, AsyncWriterError)
        finally:
            db.close()

    def test_restarted_shard_picks_up_retried_block(self, tmp_path):
        store = LSMStore(str(tmp_path / "s0"))
        srv = ShardServer(store).start()
        port = srv.port
        db = NetMultiInstanceDB(addresses=[srv.address], io_timeout=IO)
        pool = WriterPool(db, max_retries=8, retry_backoff_s=0.05)
        revived = []
        try:
            srv.stop()
            r, c, v = rand_triples(1, n=30)
            pool.submit(r, c, v)

            def revive():
                time.sleep(0.2)
                revived.append(ShardServer(store, port=port).start())
            t = threading.Thread(target=revive)
            t.start()
            pool.flush()
            t.join(timeout=IO)
            assert pool.n_written == 30
            assert pool.n_retried >= 1
            assert db.n_entries == 30
        finally:
            pool.close()
            db.close()
            for s in revived:
                s.stop()

    def test_dead_shard_scan_raises_connection_error(self, pair):
        p, j = pair
        for db in (p, j):
            db.put_triples(*rand_triples(2, n=30))
            db.servers[1].stop()
            with pytest.raises(ConnectionError, match="db1"):
                snapshot(db)

    def test_stalled_shard_times_out(self):
        """A shard that accepts and never answers fails the RPC within
        ``io_timeout`` instead of hanging the caller."""
        lsn = socket.create_server(("127.0.0.1", 0))
        held = []
        t = threading.Thread(target=lambda: held.append(lsn.accept()[0]),
                             daemon=True)
        t.start()
        client = ShardClient(f"127.0.0.1:{lsn.getsockname()[1]}",
                             io_timeout=0.3)
        try:
            t0 = time.monotonic()
            with pytest.raises(ConnectionError, match="during ping"):
                client.ping()
            assert time.monotonic() - t0 < 5.0
        finally:
            client.close()
            for s in held:
                s.close()
            lsn.close()


class TestSyncBarrier:
    def test_flush_is_cross_shard_durability_point(self, tmp_path):
        """flush() fsyncs every shard's WAL; abandoning the cluster loses
        nothing: the port's and the reference's LSM stores both reopen
        the shard directories with every entry and degree sum."""
        d = str(tmp_path / "m")
        T = DB("Tedge", "TedgeT", "TedgeDeg", backend="net", path=d,
               n_instances=2, cache_ttl=0, io_timeout=IO)
        r, c, v = rand_triples(4, n=120)
        n_put = put(T, Assoc(r, c, v), sync=False)
        T.flush()
        before = snapshot(T.backend)
        deg = degrees(T.backend)
        for srv in T.backend.servers:
            assert srv.store.n_syncs >= 1
            srv.stop()
        for inst in T.backend.instances:
            inst.close()
        R = DB("Tedge", "TedgeT", "TedgeDeg", backend="lsm", path=d,
               n_instances=2, cache_ttl=0)
        assert snapshot(R.backend) == before
        assert degrees(R.backend) == deg
        assert R.n_entries == n_put
        JR = JDB("Tedge", "TedgeT", "TedgeDeg", backend="lsm", path=d,
                 n_instances=2, cache_ttl=0)
        assert snapshot(JR.backend) == before and degrees(JR.backend) == deg

    def test_clean_barrier_skips_rpcs(self, pair):
        p, _ = pair
        p.put_triples(*rand_triples(5, n=20))
        p.sync()
        n0 = sum(i.n_rpcs for i in p.instances)
        for _ in range(10):
            p.sync()
        assert sum(i.n_rpcs for i in p.instances) == n0
        p.put_triples(*rand_triples(5, n=5))
        p.sync()
        assert sum(i.n_rpcs for i in p.instances) > n0


class TestProperties:
    @settings(max_examples=12, deadline=None)
    @given(trip=st.lists(st.tuples(st.integers(0, 15), st.integers(0, 6),
                                   st.integers(0, 3)),
                         min_size=1, max_size=60),
           n_instances=st.integers(1, 3))
    def test_random_triples_agree_with_reference(self, trip, n_instances):
        p = NetMultiInstanceDB(n_instances=n_instances, io_timeout=IO)
        j = JNetMultiInstanceDB(n_instances=n_instances)
        try:
            r = np.asarray([f"p{a:02d}" for a, _, _ in trip])
            c = np.asarray([f"f|{b}" for _, b, _ in trip])
            v = np.asarray([str(x) for _, _, x in trip])
            e = EdgeStore(n_tablets=2)
            for store in (p, j, e):
                store.put_triples(r, c, v)
            for t in (False, True):
                assert snapshot(p, t) == snapshot(j, t) == snapshot(e, t)
            assert degrees(p) == degrees(j) == degrees(e)
            assert p.n_entries == j.n_entries
        finally:
            p.close()
            j.close()


class TestStandaloneServer:
    def test_cli_shard_server_over_subprocess(self, tmp_path):
        """``python -m repro_torch.db.netstore --port 0 --path DIR`` prints
        ``LISTENING host:port``, serves a binding in this process, exits 0
        on SIGTERM, and leaves a store both packages reopen."""
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.db.netstore", "--port", "0",
             "--path", str(tmp_path / "shard0")],
            env={**os.environ, "PYTHONPATH": SRC, "REPRO_TORCH_DEVICE": "cpu"},
            stdout=subprocess.PIPE, text=True)
        try:
            line = []
            t = threading.Thread(
                target=lambda: line.append(proc.stdout.readline()),
                daemon=True)
            t.start()
            t.join(timeout=60)
            assert line and line[0].startswith("LISTENING "), line
            addr = line[0].split()[1]
            T = DB("Tedge", "TedgeT", "TedgeDeg", backend="net",
                   addresses=[addr], cache_ttl=0, io_timeout=IO)
            put(T, Assoc("p1,p2,", "ip.dst|a,ip.dst|b,", "1,1,"),
                sync=False)
            T.flush()
            assert T[:, "ip.dst|*,"].eval().nnz == 2
            assert T.degree("ip.dst|a") == 1.0
            T.close()
            T.backend.close()
        finally:
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        s = LSMStore(str(tmp_path / "shard0"))
        assert s.n_entries == 2
        s.close()
        from repro.db import LSMStore as JLSMStore
        j = JLSMStore(str(tmp_path / "shard0"))
        assert j.n_entries == 2 and degrees(j) == {"ip.dst|a": 1.0,
                                                   "ip.dst|b": 1.0}
        j.close()
