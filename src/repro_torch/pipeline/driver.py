"""End-to-end pipeline driver — the paper's Fig. 4 as a task DAG.

``build_tasks`` wires N capture files through
uncompress → split → parse → sort → sparse → ingest with per-file
dependency chains; ``run_pipeline`` executes the DAG on the runner and
returns per-stage timing/size stats (the data behind Fig. 5 and the
expansion-factor table).

This module (plus ~10 lines of user script, see examples/pcap_pipeline.py)
is the analog of the paper's "135 lines of D4M code".
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional

from . import pcap as P
from . import stages
from .runner import FaultInjector, Runner, Task


@dataclasses.dataclass
class PipelineConfig:
    workdir: str
    n_files: int = 4                    # capture files (paper: 385)
    duration_per_file_s: float = 0.05   # paper: ~15 min per file
    split_size: int = 64 * 1024         # paper: 5 MB
    traffic: P.TrafficConfig = dataclasses.field(default_factory=P.TrafficConfig)
    n_workers: int = 4
    journal: Optional[str] = None       # default: <workdir>/journal.jsonl


def build_tasks(cfg: PipelineConfig, db) -> List[Task]:
    os.makedirs(cfg.workdir, exist_ok=True)
    tasks: List[Task] = []
    results: Dict[str, stages.StageResult] = {}

    def record(tid):
        def deco(fn):
            def wrapped():
                res = fn()
                results[tid] = res
                return res
            return wrapped
        return deco

    for i in range(cfg.n_files):
        raw = os.path.join(cfg.workdir, f"capture{i:04d}.pcap.gz")
        tcfg = dataclasses.replace(cfg.traffic, seed=cfg.traffic.seed + i)
        t0 = 1_492_000_000.0 + i * cfg.duration_per_file_s

        gen_id = f"generate/{i}"
        tasks.append(Task(gen_id, record(gen_id)(
            lambda raw=raw, tcfg=tcfg, t0=t0:
                stages.generate(raw, tcfg, cfg.duration_per_file_s, t0)),
            stage="generate"))

        unc_id = f"uncompress/{i}"
        tasks.append(Task(unc_id, record(unc_id)(
            lambda raw=raw: stages.uncompress(raw)),
            deps=(gen_id,), stage="uncompress"))

        spl_id = f"split/{i}"
        tasks.append(Task(spl_id, record(spl_id)(
            lambda raw=raw: stages.split(raw[:-3], cfg.split_size)),
            deps=(unc_id,), stage="split"))

        # The split fan-out is data-dependent; downstream per-chunk work is
        # built lazily inside one task per (file, stage) that maps its chunks.
        def chain(i=i, raw=raw, spl_id=spl_id):
            def parse_all():
                outs = []
                r_in = r_out = 0
                for part in sorted(glob.glob(raw[:-8] + ".split*.pcap")):
                    res = stages.parse(part)
                    outs += res.outputs
                    r_in += res.bytes_in
                    r_out += res.bytes_out
                return stages.StageResult(outs, r_in, r_out)

            def map_stage(fn, pattern):
                def run():
                    outs = []
                    r_in = r_out = 0
                    for part in sorted(glob.glob(pattern)):
                        res = fn(part)
                        outs += res.outputs
                        r_in += res.bytes_in
                        r_out += res.bytes_out
                    return stages.StageResult(outs, r_in, r_out)
                return run

            par_id = f"parse/{i}"
            srt_id = f"sort/{i}"
            sps_id = f"sparse/{i}"
            ing_id = f"ingest/{i}"
            tasks.append(Task(par_id, record(par_id)(parse_all),
                              deps=(spl_id,), stage="parse"))
            tasks.append(Task(srt_id, record(srt_id)(map_stage(
                stages.sort_stage, raw[:-8] + ".split*.pcap.tsv")),
                deps=(par_id,), stage="sort"))
            tasks.append(Task(sps_id, record(sps_id)(map_stage(
                stages.sparse_stage, raw[:-8] + ".split*.pcap.tsv.A.npz")),
                deps=(srt_id,), stage="sparse"))
            # defer_commit: ingest only *enqueues* writes, so its journal
            # entry is committed at the flush barrier (where the writes
            # are applied and fsync'd) — a crash in between re-runs the
            # ingest on restart instead of silently losing the writes
            tasks.append(Task(ing_id, record(ing_id)(map_stage(
                lambda p: stages.ingest(p, db),
                raw[:-8] + ".split*.pcap.tsv.A.E.npz")),
                deps=(sps_id,), stage="ingest", defer_commit=True))
        chain()

    # flush barrier: ingest tasks only *enqueue* writes (async writer
    # pool); this task is the commit point where all queued mutations
    # are applied (and fsync'd on durable backends) — and where any
    # writer error surfaces.  commit_point: the runner journals the
    # deferred ingest tasks only once this barrier completes.
    flush_id = "flush/writers"

    def flush_writers():
        from ..db.binding import bind
        bind(db).flush()
        return stages.StageResult([], 0, 0)

    tasks.append(Task(flush_id, record(flush_id)(flush_writers),
                      deps=("*",), stage="flush", commit_point=True))

    # expose per-task results on the task list for the driver to collect
    build_tasks.results = results  # type: ignore[attr-defined]
    return tasks


def run_pipeline(cfg: PipelineConfig, db,
                 fault_injector: Optional[FaultInjector] = None,
                 n_workers: Optional[int] = None) -> dict:
    journal = cfg.journal or os.path.join(cfg.workdir, "journal.jsonl")
    tasks = build_tasks(cfg, db)
    runner = Runner(n_workers=n_workers or cfg.n_workers,
                    journal_path=journal, fault_injector=fault_injector)
    runner.run(tasks)
    # the flush barrier task is journaled like any other; on a partial
    # restart it may be skipped while fresh ingest tasks enqueued new
    # writes — flush again here so run_pipeline never returns with
    # queued (or, on durable backends, un-fsync'd) mutations, then
    # journal any ingest tasks whose commit was deferred to a barrier
    # that only ran in a previous incarnation
    from ..db.binding import bind
    bind(db).flush()
    runner.commit_deferred()
    results = build_tasks.results  # type: ignore[attr-defined]
    per_stage: Dict[str, dict] = {}
    for tid, res in results.items():
        stage = tid.split("/")[0]
        st = per_stage.setdefault(stage, {"bytes_in": 0, "bytes_out": 0,
                                          "n_tasks": 0})
        st["bytes_in"] += res.bytes_in
        st["bytes_out"] += res.bytes_out
        st["n_tasks"] += 1
    for stage, timing in runner.stats.items():
        per_stage.setdefault(stage, {}).update(timing)
    return {"stages": per_stage, "db_entries": db.n_entries}
