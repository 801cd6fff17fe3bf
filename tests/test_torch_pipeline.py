"""The port's six-stage pipeline (``repro_torch.pipeline``: runner,
stages, driver) against the JAX package's, on the same seeded traffic.

The runner cases are those of tests/test_pipeline.py run on the port's
runner.  The stages and the driver are host code, so the two packages
must agree exactly: the same bytes on disk after each stage, the same
per-stage byte counts and database entries, identical Tedge and TedgeDeg
scans, and the same ``detect_c2`` top-k.  The C2 scores are float32
arithmetic on both sides and are compared within rtol=1e-5, atol=1e-6.
"""
import glob
import gzip
import os
import threading
import time

import numpy as np
import pytest

from _hyp import given, settings, st  # hypothesis, skipping when absent
from repro import analytics as janalytics
from repro.core.assoc import Assoc as JAssoc
from repro.db import MultiInstanceDB as JMultiInstanceDB
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import TrafficConfig as JTrafficConfig
from repro.pipeline import run_pipeline as jrun_pipeline
from repro.pipeline import stages as jstages
from repro_torch import analytics
from repro_torch.core.assoc import Assoc
from repro_torch.db import EdgeStore, MultiInstanceDB
from repro_torch.device import set_device
from repro_torch.pipeline import (FaultInjector, PipelineConfig, Runner,
                                  Task, TrafficConfig, botnet_truth,
                                  run_pipeline, stages)

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
STAGES = ("generate", "uncompress", "split", "parse", "sort", "sparse",
          "ingest", "flush")
# a small window with the injected C2 visible: 2 files x 20 s, split
# into several chunks each
TRAFFIC = dict(n_hosts=128, pkt_rate=100.0, n_bots=10, beacon_period_s=4.0,
               beacon_jitter_s=0.1, seed=5)
CONFIG = dict(n_files=2, duration_per_file_s=20.0, split_size=32 * 1024,
              n_workers=2)


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def snapshot(store, transpose=False):
    return sorted((k, tuple(sorted(cells.items())))
                  for k, cells in store.scan_everything(transpose=transpose))


def degrees(store):
    return dict(store.degree_items())


def load_union(workdir, assoc_cls):
    E = assoc_cls()
    for p in sorted(glob.glob(os.path.join(workdir, "*.E.npz"))):
        E = E + assoc_cls.load(p)
    return E


# ---------------------------------------------------------------------------
# Runner (tests/test_pipeline.py's cases on the port's runner)
# ---------------------------------------------------------------------------

class TestRunner:
    def _tasks(self, results, n=8):
        def make(i):
            def fn():
                results.append(i)
                return i
            return fn
        return [Task(f"t{i}", make(i), stage="s") for i in range(n)]

    def test_runs_all(self):
        out = []
        recs = Runner(n_workers=3).run(self._tasks(out))
        assert len(recs) == 8 and sorted(out) == list(range(8))

    def test_dependencies_respected(self):
        order = []
        t1 = Task("a", lambda: order.append("a"))
        t2 = Task("b", lambda: order.append("b"), deps=("a",))
        t3 = Task("c", lambda: order.append("c"), deps=("b",))
        Runner(n_workers=2).run([t3, t1, t2])
        assert order == ["a", "b", "c"]

    def test_fault_injection_retries(self):
        out = []
        fi = FaultInjector(kill_rate=0.5, seed=0, max_kills=5)
        recs = Runner(n_workers=2, fault_injector=fi,
                      max_retries=10).run(self._tasks(out))
        assert len(recs) == 8
        assert fi.kills > 0

    def test_permanent_failure_raises(self):
        def boom():
            raise RuntimeError("hard failure")
        with pytest.raises(RuntimeError, match="failed permanently"):
            Runner(n_workers=1, max_retries=1).run(
                [Task("x", boom, stage="s")])

    def test_journal_restart_skips_done(self, tmp_path):
        journal = str(tmp_path / "j.jsonl")
        counter = {"n": 0}

        def work():
            counter["n"] += 1
        tasks = [Task(f"t{i}", work, stage="s") for i in range(4)]
        Runner(n_workers=2, journal_path=journal).run(tasks)
        assert counter["n"] == 4
        Runner(n_workers=2, journal_path=journal).run(tasks)
        assert counter["n"] == 4

    def test_straggler_speculation(self):
        """A hung task gets a backup copy; first finisher wins."""
        state = {"calls": 0}

        def sometimes_slow():
            first = state["calls"]
            state["calls"] += 1
            if first == 0:
                time.sleep(3.0)
            return "done"
        fast = [Task(f"f{i}", lambda: time.sleep(0.01), stage="s")
                for i in range(6)]
        slow = Task("slow", sometimes_slow, stage="s")
        r = Runner(n_workers=3, straggler_factor=2.0, straggler_min_s=0.3)
        t0 = time.time()
        recs = r.run(fast + [slow])
        assert "slow" in recs
        assert time.time() - t0 < 2.9
        assert state["calls"] >= 2

    def test_barrier_and_deferred_commit(self, tmp_path):
        """A ``"*"`` barrier runs after every other task; a defer_commit
        task is journaled only when the commit-point barrier finishes."""
        journal = str(tmp_path / "j.jsonl")
        order = []
        lock = threading.Lock()

        def note(name):
            def fn():
                with lock:
                    order.append(name)
            return fn
        tasks = [Task("a", note("a"), stage="s"),
                 Task("b", note("b"), stage="s", defer_commit=True),
                 Task("flush", note("flush"), deps=("*",), stage="f",
                      commit_point=True)]
        r = Runner(n_workers=2, journal_path=journal)
        r.run(tasks)
        assert order[-1] == "flush" and sorted(order[:2]) == ["a", "b"]
        with open(journal) as f:
            ids = [line.split('"task_id": "')[1].split('"')[0] for line in f]
        assert set(ids) == {"a", "b", "flush"}
        assert ids.index("b") < ids.index("flush")


class TestRunnerProperties:
    @settings(max_examples=15, deadline=None)
    @given(n=st.integers(2, 12), workers=st.integers(1, 4), data=st.data())
    def test_random_dag_executes_each_task_once_in_order(self, n, workers,
                                                         data):
        """Any random DAG runs every task exactly once, and every task
        starts only after all its dependencies finished."""
        deps = {}
        for i in range(n):
            pool = list(range(i))
            k = data.draw(st.integers(0, min(2, len(pool))))
            deps[i] = tuple(f"t{j}" for j in
                            (data.draw(st.permutations(pool))[:k] if pool
                             else []))
        lock = threading.Lock()
        finished = set()
        runs = []

        def make(i):
            def fn():
                with lock:
                    for d in deps[i]:
                        assert int(d[1:]) in finished, \
                            f"t{i} ran before {d}"
                    runs.append(i)
                    finished.add(i)
            return fn

        tasks = [Task(f"t{i}", make(i), deps=deps[i], stage="s")
                 for i in range(n)]
        recs = Runner(n_workers=workers, speculative=False).run(tasks)
        assert len(recs) == n
        assert sorted(runs) == list(range(n))


class TestElasticity:
    def test_set_workers_mid_run(self):
        """The worker pool grows while a run is in flight."""
        r = Runner(n_workers=1, speculative=False)
        started = threading.Event()

        def slowish():
            started.set()
            time.sleep(0.05)
        tasks = [Task(f"t{i}", slowish, stage="s") for i in range(12)]

        def grow():
            started.wait(timeout=5)
            r.set_workers(4)
        g = threading.Thread(target=grow)
        g.start()
        t0 = time.time()
        recs = r.run(tasks)
        g.join(timeout=5)
        assert not g.is_alive()
        assert len(recs) == 12
        assert time.time() - t0 < 0.55


# ---------------------------------------------------------------------------
# Stages: the same bytes as the JAX package's
# ---------------------------------------------------------------------------

class TestStagesAgree:
    def test_each_stage_writes_the_same_bytes(self, tmp_path):
        tcfg = dict(n_hosts=64, pkt_rate=20000.0, seed=1)
        outs = {}
        for tag, mod, tc in (("jax", jstages, JTrafficConfig),
                             ("port", stages, TrafficConfig)):
            d = tmp_path / tag
            d.mkdir()
            raw = str(d / "f.pcap.gz")
            res = [mod.generate(raw, tc(**tcfg), 0.05), mod.uncompress(raw),
                   mod.split(raw[:-3], split_size=16 * 1024)]
            parts = res[-1].outputs
            assert len(parts) > 1
            for p in parts:
                res += [mod.parse(p), mod.sort_stage(p + ".tsv"),
                        mod.sparse_stage(p + ".tsv.A.npz")]
            outs[tag] = (d, [(r.bytes_in, r.bytes_out) for r in res])
        (jd, jres), (pd, pres) = outs["jax"], outs["port"]
        assert jres == pres
        with gzip.open(jd / "f.pcap.gz") as a, gzip.open(pd / "f.pcap.gz") as b:
            assert a.read() == b.read()
        names = sorted(os.listdir(jd))
        assert names == sorted(os.listdir(pd))
        for name in names:
            if name.endswith((".pcap", ".tsv")):
                assert (jd / name).read_bytes() == (pd / name).read_bytes()
            elif name.endswith(".npz"):
                a = JAssoc.load(str(jd / name)).triples()
                b = Assoc.load(str(pd / name)).triples()
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(np.asarray(x),
                                                  np.asarray(y))

    def test_split_preserves_records(self, tmp_path):
        from repro_torch.pipeline import pcap as P
        rec = P.synth_packets(TrafficConfig(n_hosts=64, pkt_rate=20000.0,
                                            seed=1), 0.05)
        src = str(tmp_path / "f.pcap")
        P.write_pcap(src, rec)
        res = stages.split(src, split_size=16 * 1024)
        assert len(res.outputs) > 1
        assert sum(P.read_pcap(p).shape[0] for p in res.outputs) == \
            rec.shape[0]

    def test_uncompress_expands(self, tmp_path):
        raw = str(tmp_path / "f.pcap.gz")
        stages.generate(raw, TrafficConfig(n_hosts=64, pkt_rate=20000.0,
                                           seed=1), 0.05)
        unc = stages.uncompress(raw)
        assert unc.bytes_out > unc.bytes_in


# ---------------------------------------------------------------------------
# The driver end to end, against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """The same pipeline config through both packages' ``run_pipeline``
    into a two-instance memory store each."""
    out = {}
    for tag, run, cfg_cls, tc_cls, db_cls in (
            ("jax", jrun_pipeline, JPipelineConfig, JTrafficConfig,
             JMultiInstanceDB),
            ("port", run_pipeline, PipelineConfig, TrafficConfig,
             MultiInstanceDB)):
        work = str(tmp_path_factory.mktemp(tag))
        db = db_cls(n_instances=2, tablets_per_instance=4)
        stats = run(cfg_cls(workdir=work, traffic=tc_cls(**TRAFFIC),
                            **CONFIG), db)
        out[tag] = (work, db, stats)
    return out


class TestEndToEnd:
    def test_stage_bytes_and_entries_agree(self, both_runs):
        (_, _, js), (_, _, ps) = both_runs["jax"], both_runs["port"]
        assert set(ps["stages"]) == set(STAGES)
        for stage in STAGES:
            for key in ("bytes_in", "bytes_out", "n_tasks", "n"):
                assert ps["stages"][stage][key] == js["stages"][stage][key], \
                    (stage, key)
        assert ps["db_entries"] == js["db_entries"] > 0
        assert ps["stages"]["split"]["bytes_out"] > \
            ps["stages"]["split"]["bytes_in"]          # several chunks

    def test_tables_agree(self, both_runs):
        jdb, pdb = both_runs["jax"][1], both_runs["port"][1]
        for transpose in (False, True):
            assert snapshot(pdb, transpose) == snapshot(jdb, transpose)
        assert degrees(pdb) == degrees(jdb)
        r, c, v = pdb.degree_assoc().triples()
        jr, jc, jv = jdb.degree_assoc().triples()
        assert list(r) == list(jr) and list(c) == list(jc)
        np.testing.assert_array_equal(np.asarray(v, float),
                                      np.asarray(jv, float))

    def test_detect_c2_agrees_and_recovers(self, both_runs):
        (jw, jdb, _), (pw, pdb, _) = both_runs["jax"], both_runs["port"]
        E, JE = load_union(pw, Assoc), load_union(jw, JAssoc)
        assert E.shape == JE.shape and E.nnz == JE.nnz
        rep = analytics.detect_c2(E, top_k=8)
        jrep = janalytics.detect_c2(JE, top_k=8)
        assert list(rep.hosts) == list(jrep.hosts)
        np.testing.assert_allclose(np.asarray(rep.scores, np.float64),
                                   np.asarray(jrep.scores, np.float64),
                                   **SCORE_TOL)
        c2 = botnet_truth(TrafficConfig(**TRAFFIC))["c2"]
        assert c2 in list(rep.hosts[:3])
        conns = pdb.connections(c2)
        assert len(conns) >= 10 and conns == jdb.connections(c2)
        assert pdb.degree(f"ip.dst|{c2}") == jdb.degree(f"ip.dst|{c2}") > 0

    def test_restart_skips_journaled_tasks(self, both_runs):
        """Rerunning on the same journal executes nothing: no double
        ingest into a fresh store."""
        work = both_runs["port"][0]
        db = MultiInstanceDB(n_instances=2, tablets_per_instance=4)
        stats = run_pipeline(PipelineConfig(
            workdir=work, traffic=TrafficConfig(**TRAFFIC), **CONFIG), db)
        assert db.n_entries == 0
        assert stats["stages"] == {}


class TestRestart:
    def test_partial_journal_resumes(self, tmp_path):
        """A run whose journal lost its last file's tail (a crash before
        those tasks were journaled) resumes them, and only them."""
        tcfg = TrafficConfig(n_hosts=64, pkt_rate=500.0, seed=6)
        cfg = PipelineConfig(workdir=str(tmp_path), n_files=2,
                             duration_per_file_s=1.0, traffic=tcfg,
                             n_workers=2)
        full = EdgeStore(n_tablets=2)
        run_pipeline(cfg, full)
        journal = tmp_path / "journal.jsonl"
        lost = ("sort/1", "sparse/1", "ingest/1", "flush/writers")
        kept = [line for line in journal.read_text().splitlines()
                if not any(f'"{t}"' in line for t in lost)]
        journal.write_text("\n".join(kept) + "\n")
        db = EdgeStore(n_tablets=2)
        stats = run_pipeline(cfg, db)
        ran = {s: st.get("n_tasks", 0) for s, st in stats["stages"].items()}
        assert ran == {"sort": 1, "sparse": 1, "ingest": 1, "flush": 1}
        assert 0 < db.n_entries < full.n_entries
        E = Assoc()
        for p in sorted(glob.glob(str(tmp_path / "capture0001*.E.npz"))):
            E = E + Assoc.load(p)
        assert db.n_entries == E.nnz
        again = EdgeStore(n_tablets=2)
        run_pipeline(cfg, again)
        assert again.n_entries == 0

    def test_faults_leave_the_same_tables(self, tmp_path):
        tcfg = TrafficConfig(n_hosts=64, pkt_rate=500.0, seed=6)
        stores = []
        for tag, fault in (("clean", None),
                           ("faulty", FaultInjector(kill_rate=0.3, seed=1,
                                                    max_kills=6))):
            db = MultiInstanceDB(n_instances=2, tablets_per_instance=2)
            run_pipeline(PipelineConfig(
                workdir=str(tmp_path / tag), n_files=2,
                duration_per_file_s=1.0, traffic=tcfg, n_workers=2),
                db, fault_injector=fault)
            stores.append(db)
        assert stores[1].n_entries == stores[0].n_entries > 0
        assert snapshot(stores[1]) == snapshot(stores[0])
        assert degrees(stores[1]) == degrees(stores[0])
