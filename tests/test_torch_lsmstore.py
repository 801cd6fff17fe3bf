"""The port's persistent LSM store (``repro_torch.db.lsmstore``) against
the JAX package's, on the same triples: scans, degrees and entry counts
must be identical, both stores read each other's directories (one on-disk
format), and the pipeline's crash-after-flush recovery holds for the
port.  All host code: every comparison is exact."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _hyp import given, settings, st  # hypothesis, skipping when absent
from repro.db import LSMMultiInstanceDB as JLSMMultiInstanceDB
from repro.db import LSMStore as JLSMStore
from repro_torch.core.assoc import Assoc
from repro_torch.db import (DB, EdgeStore, LSMMultiInstanceDB, LSMStore,
                            MultiInstanceDB, bind, put)
from repro_torch.device import set_device
from repro_torch.pipeline import PipelineConfig, TrafficConfig, run_pipeline

SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def rand_triples(seed, n=200, n_rows=40, n_cols=12):
    rng = np.random.default_rng(seed)
    r = np.asarray([f"p{i:03d}" for i in rng.integers(0, n_rows, n)])
    c = np.asarray([f"ip.dst|{i}" if i % 2 else f"ip.src|{i}"
                    for i in rng.integers(0, n_cols, n)])
    v = rng.integers(0, 9, n).astype(str)
    return r, c, v


def snapshot(store, transpose=False):
    return [(k, tuple(sorted(cells.items())))
            for k, cells in store.scan_everything(transpose=transpose)]


def degrees(store):
    return dict(store.degree_items())


def observe(store, r, c):
    """Everything the scan protocol answers, as plain values."""
    out = {"n_entries": store.n_entries, "deg": degrees(store)}
    for t in (False, True):
        lo, hi = ("p005", "p025") if not t else ("ip.dst|", "ip.src|5")
        out[t] = (snapshot(store, t),
                  list(store.scan_key_range(lo, hi, transpose=t)),
                  list(store.scan_prefix("p01" if not t else "ip.dst|",
                                         transpose=t)),
                  list(store.scan_keys([r[0], r[7], "absent"], transpose=t)))
    out["prefix"] = sorted(store.keys_with_prefix("ip.dst|"))
    out["point"] = [store.degree(k) for k in sorted(set(c[:20]))]
    out["conn"] = store.connections("3")
    return out


def fill(store, r, c, v, step=50):
    for lo in range(0, len(r), step):       # batched: interleaved spills
        store.put_triples(r[lo:lo + step], c[lo:lo + step], v[lo:lo + step])


class TestAgainstReference:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("limit", [70, 100_000])
    def test_same_triples_same_answers(self, tmp_path, seed, limit):
        """Spilled runs (limit 70) and memtable only (100,000)."""
        r, c, v = rand_triples(seed, n=250)
        s = LSMStore(str(tmp_path / "port"), memtable_limit=limit)
        j = JLSMStore(str(tmp_path / "jax"), memtable_limit=limit)
        fill(s, r, c, v)
        fill(j, r, c, v)
        assert s.n_runs == j.n_runs
        assert observe(s, r, c) == observe(j, r, c)
        e = EdgeStore(n_tablets=3)
        fill(e, r, c, v)
        assert snapshot(s) == snapshot(e) and degrees(s) == degrees(e)

    def test_compaction_agrees(self, tmp_path):
        r, c, v = rand_triples(7, n=400)
        s = LSMStore(str(tmp_path / "port"), memtable_limit=60, max_runs=100)
        j = JLSMStore(str(tmp_path / "jax"), memtable_limit=60, max_runs=100)
        fill(s, r, c, v)
        fill(j, r, c, v)
        assert s.n_runs > 1
        s.compact()
        j.compact()
        assert s.n_runs == j.n_runs == 1
        assert observe(s, r, c) == observe(j, r, c)

    def test_reads_the_reference_directory(self, tmp_path):
        """One on-disk format: the port reopens a directory the JAX
        package wrote (runs and WAL), and the other way round."""
        r, c, v = rand_triples(3, n=300)
        d_j, d_p = str(tmp_path / "j"), str(tmp_path / "p")
        j = JLSMStore(d_j, memtable_limit=80)
        fill(j, r, c, v)
        j.sync()
        p = LSMStore(d_p, memtable_limit=80)
        fill(p, r, c, v)
        p.sync()
        assert observe(LSMStore(d_j), r, c) == observe(j, r, c)
        assert observe(JLSMStore(d_p), r, c) == observe(p, r, c)

    def test_multi_instance_places_rows_alike(self, tmp_path):
        r, c, v = rand_triples(4, n=300)
        p = LSMMultiInstanceDB(str(tmp_path / "p"), n_instances=3)
        j = JLSMMultiInstanceDB(str(tmp_path / "j"), n_instances=3)
        p.put_triples(r, c, v)
        j.put_triples(r, c, v)
        for pi, ji in zip(p.instances, j.instances):
            assert snapshot(pi) == snapshot(ji)
            assert degrees(pi) == degrees(ji)
        assert p.n_entries == j.n_entries
        assert degrees(p) == degrees(j)

    def test_put_degree(self, tmp_path):
        s = LSMStore(str(tmp_path / "p"))
        j = JLSMStore(str(tmp_path / "j"))
        vals = np.asarray([3.0, 4.0])
        s.put_degree(Assoc("ip.dst|a,ip.dst|b,", "degree,degree,", vals))
        from repro.core.assoc import Assoc as JAssoc
        j.put_degree(JAssoc("ip.dst|a,ip.dst|b,", "degree,degree,", vals))
        assert degrees(s) == degrees(j) == {"ip.dst|a": 3.0, "ip.dst|b": 4.0}


class TestRecovery:
    def test_reopen_replays_synced_writes(self, tmp_path):
        d = str(tmp_path / "lsm")
        s = LSMStore(d)
        r, c, v = rand_triples(1, n=120)
        s.put_triples(r, c, v)
        s.sync()
        s2 = LSMStore(d)                      # no close: a simulated crash
        assert snapshot(s2) == snapshot(s) and degrees(s2) == degrees(s)
        assert s2.n_entries == s.n_entries

    def test_torn_wal_tail_truncated(self, tmp_path):
        """A crash mid-append tears the last frame: both packages replay
        the whole frames of the same log and cut the tail alike."""
        logs = {}
        for tag, cls in (("p", LSMStore), ("j", JLSMStore)):
            d = str(tmp_path / tag)
            s = cls(d)
            s.put_triples(*rand_triples(2, n=30))
            s.sync()
            s.put_triples(*[np.asarray(x) for x in
                            (["p900"], ["ip.dst|z"], ["1"])])
            s.close()
            wal = Path(d) / "wal.log"
            with open(wal, "r+b") as f:
                f.seek(0, os.SEEK_END)
                f.truncate(f.tell() - 3)      # tear the second frame
            s2 = cls(d)
            assert s2.row("p900") == {} and s2.degree("ip.dst|z") == 0.0
            logs[tag] = (snapshot(s2), degrees(s2), wal.read_bytes())
        assert logs["p"] == logs["j"]

    def test_spill_then_reopen(self, tmp_path):
        d = str(tmp_path / "lsm")
        r, c, v = rand_triples(5, n=300)
        s = LSMStore(d, memtable_limit=50)
        fill(s, r, c, v)
        s.sync()
        assert s.n_runs
        s2 = LSMStore(d, memtable_limit=50)
        assert observe(s2, r, c) == observe(s, r, c)


class TestBinding:
    def test_registry_and_queries(self, tmp_path):
        T = DB("Tedge", "TedgeT", "TedgeDeg", backend="lsm",
               path=str(tmp_path / "a"), n_instances=2)
        assert isinstance(T.backend, LSMMultiInstanceDB)
        assert os.path.isdir(str(tmp_path / "a" / "db1"))
        E = Assoc("p1,p1,p2,p3,", "ip.dst|a,ip.src|b,ip.dst|a,ip.dst|c,",
                  "1,1,1,1,")
        put(T, E, sync=False)
        assert T[:, "ip.dst|*,"].eval().nnz == 3
        assert T.degree("ip.dst|a") == 2.0
        assert T["p1,", :].eval().nnz == 2
        T.close()
        T1 = DB("Tedge", backend="lsm", path=str(tmp_path / "b"),
                memtable_limit=7)
        assert isinstance(T1.backend, LSMStore)
        assert T1.backend.memtable_limit == 7

    def test_flush_is_durability_point(self, tmp_path):
        d = str(tmp_path / "a")
        T = DB("Tedge", "TedgeT", "TedgeDeg", backend="lsm", path=d)
        put(T, Assoc("p1,", "ip.dst|a,", "1,"), sync=False)
        T.flush()
        assert T.backend.n_syncs >= 1
        T2 = DB("Tedge", "TedgeT", "TedgeDeg", backend="lsm", path=d)
        assert T2[:, :].eval().nnz == 1
        assert T2.degree("ip.dst|a") == 1.0


class TestProperties:
    @settings(max_examples=15, deadline=None)
    @given(trip=st.lists(st.tuples(st.integers(0, 15), st.integers(0, 6),
                                   st.integers(0, 3)),
                         min_size=1, max_size=60),
           limit=st.integers(1, 40))
    def test_random_triples_agree_with_reference(self, trip, limit,
                                                 tmp_path_factory):
        d = tmp_path_factory.mktemp("lsm")
        s = LSMStore(str(d / "p"), memtable_limit=limit)
        j = JLSMStore(str(d / "j"), memtable_limit=limit)
        e = EdgeStore(n_tablets=2)
        r = np.asarray([f"p{a:02d}" for a, _, _ in trip])
        c = np.asarray([f"f|{b}" for _, b, _ in trip])
        v = np.asarray([str(x) for _, _, x in trip])
        for store in (s, j, e):
            store.put_triples(r, c, v)
        for t in (False, True):
            assert snapshot(s, t) == snapshot(j, t) == snapshot(e, t)
        assert degrees(s) == degrees(j) == degrees(e)
        assert s.n_entries == j.n_entries


CRASH_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[4])
os.environ["REPRO_TORCH_DEVICE"] = "cpu"
from repro_torch.db import DB
from repro_torch.pipeline import PipelineConfig, TrafficConfig, run_pipeline

workdir, dbdir, backend = sys.argv[1], sys.argv[2], sys.argv[3]
cfg = PipelineConfig(workdir=workdir, n_files=2, duration_per_file_s=1.0,
                     traffic=TrafficConfig(n_hosts=64, pkt_rate=500.0,
                                           seed=6), n_workers=2)
T = DB("Tedge", "TedgeT", "TedgeDeg", backend=backend,
       path=(dbdir if backend == "lsm" else None), n_instances=2)
stats = run_pipeline(cfg, T.backend)
print("ENTRIES", stats["db_entries"], flush=True)
os._exit(17)   # kill after the flush barrier: no close(), no atexit
"""


class TestPipelineCrashRecovery:
    def test_lsm_recovers_full_ingest_after_kill(self, tmp_path):
        """The port's pipeline into backend='lsm', the process killed
        right after the flush barrier; reopening recovers every entry,
        equal to the same pipeline into the memory backend, and a
        restart on the journal re-ingests nothing."""
        dbdir = str(tmp_path / "lsmdb")
        env = dict(os.environ, REPRO_TORCH_DEVICE="cpu")
        out = subprocess.run(
            [sys.executable, "-c", CRASH_CHILD, str(tmp_path / "w_lsm"),
             dbdir, "lsm", SRC], capture_output=True, text=True,
            timeout=300, env=env)
        assert out.returncode == 17, out.stderr
        entries = int(out.stdout.split("ENTRIES")[1].split()[0])
        assert entries > 0

        mem = MultiInstanceDB(n_instances=2, tablets_per_instance=4)
        cfg = PipelineConfig(workdir=str(tmp_path / "w_mem"), n_files=2,
                             duration_per_file_s=1.0,
                             traffic=TrafficConfig(n_hosts=64,
                                                   pkt_rate=500.0, seed=6),
                             n_workers=2)
        run_pipeline(cfg, mem)

        T = DB("Tedge", "TedgeT", "TedgeDeg", backend="lsm", path=dbdir,
               n_instances=2)
        assert T.n_entries == entries == mem.n_entries
        assert degrees(T.backend) == degrees(mem)
        a = T[:, "ip.dst|*,"].eval()
        b = bind(mem, cache_ttl=0)[:, "ip.dst|*,"].eval()
        assert a.triples()[0].tolist() == b.triples()[0].tolist()
        assert a.triples()[1].tolist() == b.triples()[1].tolist()
        T2 = DB("Tedge", "TedgeT", "TedgeDeg", backend="lsm", path=dbdir,
                n_instances=2)
        run_pipeline(dataclasses.replace(cfg,
                                         workdir=str(tmp_path / "w_lsm")),
                     T2.backend)
        assert T2.n_entries == entries
