"""The paper's pipeline, pass after pass: capture files to a flushed,
readable store.

A pass is one ``repro_torch.pipeline.run_pipeline`` over ``n_files``
capture files of ``duration_per_file_s`` of the link each (generated
inside the pass, the pipeline's Stage 0), with the workload's workers
and split size, into a fresh ``MultiInstanceDB``, followed by the first
query a reader makes of the flushed store, ``fit_degree_table`` over
``ip.dst|`` (the pass's one touch of the card).  Each pass has traffic
seeds of its own, all of the same size.  Set-up makes one whole pass
(a process's first pass at this size runs slower than the rest).  The
window runs passes back to back until their summed time reaches
``seconds``; ``ingest_pkts_per_s`` is the packets of those
passes over their summed wall time.  One pass, drawn from the seed, is
held until the window has closed and then checked: its capture files
against the frozen generator's bytes, and its store's Tedge entries,
TedgeDeg sums and the fit against the reference.  Each pass's writer
threads are stopped and its workdir, under ``TMPDIR``, deleted when the
pass is done with.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
import shutil
import tempfile
import time

import numpy as np

from bench.harness.common import Check, Run
from bench.reference import compare as C
from bench.reference.d4m import fit_rank_size, pipeline_window, \
    store_mismatch
from bench.traffic import pcap_frozen, traffic_config

T0 = 1_492_000_000.0            # the pipeline driver's first capture time


def pass_records(cfg: dict, wl: dict, seed: int) -> list:
    """Each capture file's records for a pass seeded ``seed`` (file ``i``
    is seeded ``seed + i`` and starts ``i`` file lengths after T0)."""
    tc = traffic_config(cfg, seed)
    dur = float(wl["duration_per_file_s"])
    return [pcap_frozen.synth_packets(dataclasses.replace(tc, seed=seed + i),
                                      dur, t0=T0 + i * dur)
            for i in range(int(wl["n_files"]))]


class Pipeline:
    """The program under test: one pass at a time."""

    def __init__(self, cfg: dict, wl: dict, root: str):
        from repro_torch import analytics
        from repro_torch.db import MultiInstanceDB, bind
        from repro_torch.pipeline import PipelineConfig, TrafficConfig, \
            run_pipeline
        self._fit, self._bind = analytics.fit_degree_table, bind
        self._new_db = lambda: MultiInstanceDB(
            cfg["store"]["n_instances"], cfg["store"]["tablets_per_instance"])
        self._cfg = lambda work, seed, n: PipelineConfig(
            workdir=work, n_files=n,
            duration_per_file_s=float(wl["duration_per_file_s"]),
            split_size=int(wl["split_bytes"]), n_workers=int(wl["workers"]),
            traffic=TrafficConfig(**cfg["traffic"], seed=int(seed)))
        self._run = run_pipeline
        self.root = root

    def one(self, seed: int, n_files: int, sync):
        """(store, workdir, stats, fit, seconds) of one pass."""
        work = tempfile.mkdtemp(prefix="pass-", dir=self.root)
        db = self._new_db()
        t0 = time.perf_counter()
        stats = self._run(self._cfg(work, seed, n_files), db)
        fit = self._fit(self._bind(db), "ip.dst|")
        float(fit.alpha)
        sync()
        return db, work, stats, fit, time.perf_counter() - t0

    def done_with(self, db, work: str) -> None:
        """Stop a pass's writer threads and delete its workdir."""
        self._bind(db).close()
        shutil.rmtree(work, ignore_errors=True)


def run(cfg: dict, wl: dict, seed: int, seconds: float, trace: bool,
        sync, profile_cls) -> Run:
    import torch
    root = tempfile.mkdtemp(prefix="bench-pipeline-")
    try:
        return _run(cfg, wl, seed, seconds, trace, sync, profile_cls, root,
                    torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(cfg, wl, seed, seconds, trace, sync, profile_cls, root, torch):
    n_files = int(wl["n_files"])
    t_setup = time.perf_counter()
    prog = Pipeline(cfg, wl, root)
    prog.done_with(*prog.one(seed, n_files, sync)[:2])   # warm-up pass
    setup_s = time.perf_counter() - t_setup

    # the checked pass, drawn from the seed among the first two (the last
    # one where the window holds fewer); it is held until the close
    check_at = int(np.random.default_rng([seed, 0x919E]).integers(0, 2))
    passes, held, failed, error = [], None, 0, None
    prof = profile_cls().__enter__() if trace else None
    spent = 0.0
    while spent < seconds:
        p_seed = seed + n_files * (len(passes) + 1)
        try:
            db, work, stats, fit, dt = prog.one(p_seed, n_files, sync)
        except Exception as e:                  # counted; not correct
            failed, error = failed + 1, repr(e)
            break
        spent += dt
        passes.append((p_seed, stats, dt))
        if held is None and (len(passes) - 1 == check_at or spent >= seconds):
            held = (p_seed, db, work, fit)
        else:
            prog.done_with(db, work)
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0

    n_pkts = sum(r.shape[0] for s, _, _ in passes
                 for r in pass_records(cfg, wl, s))
    checked = None
    if held is not None:
        checks, notes, checked = check_pass(cfg, wl, *held)
        prog.done_with(*held[1:3])
    else:
        checks = [Check(k, float("inf"), float(v))
                  for k, v in wl["limits"].items()]
        notes = [f"no pass completed: {error}"]
    notes.insert(0, f"pipeline: {len(passes)} passes, {n_pkts} packets in "
                    f"{spent:.4f} s of passes after {setup_s:.4f} s of "
                    f"set-up; pass seconds {[round(p[2], 4) for p in passes]}")
    return Run(attempted=len(passes) + failed, failed=failed,
               metrics={"ingest_pkts_per_s": n_pkts / spent if spent else
                        None, "setup_s": setup_s},
               checks=checks, extra_correct=failed == 0, notes=notes,
               layer={"passes": [(st, dt) for _, st, dt in passes],
                      "packets": n_pkts, "checked": checked},
               profile=prof, peak_bytes=peak)


def check_pass(cfg: dict, wl: dict, seed: int, db, work: str, fit):
    """The compared numbers of one pass, read back from its store."""
    recs = pass_records(cfg, wl, seed)
    header = _pcap_header()
    bad_files = 0
    for i, rec in enumerate(recs):
        path = os.path.join(work, f"capture{i:04d}.pcap.gz")
        with gzip.open(path, "rb") as f:
            bad_files += f.read() != header + rec.tobytes()
    split_records = int(wl["split_bytes"]) // pcap_frozen.REC_DTYPE.itemsize
    rows_w, cols_w, deg_k, deg_w = pipeline_window(recs, split_records)
    from repro_torch.db import bind                 # the program's reader
    T = bind(db)
    A = T[:, :].eval()
    coo = A.sm.tocoo()
    vals = A.triples()[2] if A.val is None else A.val[coo.data.astype(
        np.int64) - 1]
    bad_vals = int((np.asarray(vals).astype(str) != "1").sum())
    tedge = store_mismatch(A.row, A.col, coo.row, coo.col, rows_w,
                           cols_w) + bad_vals
    D = T.degree_assoc("")
    dk, _, dv = D.triples()
    want = dict(zip(deg_k.tolist(), deg_w.tolist()))
    gap = C.keyed_gap(np.asarray(dk).tolist(), np.asarray(dv, np.float64),
                      want)
    got_keys = set(np.asarray(dk).tolist())
    gap = max([gap] + [v for k, v in want.items() if k not in got_keys])
    dst = deg_w[np.char.startswith(deg_k, "ip.dst|")]
    fit_gap = C.fit_rel({"alpha": float(fit.alpha), "log_c": float(fit.log_c),
                         "r2": float(fit.r2)}, fit_rank_size(dst))
    vals_ = {"capture_mismatch": float(bad_files), "tedge_mismatch":
             float(tedge), "deg_gap": float(gap), "fit_rel": fit_gap}
    limits = wl["limits"]
    return ([Check(k, v, float(limits[k])) for k, v in vals_.items()],
            [f"checked pass seeded {seed}: {rows_w.shape[0]} packets, "
             f"{A.nnz} entries read back, {len(got_keys)} degree keys"],
            (recs, rows_w, cols_w))


def control_readings(recs: list, rows_w: np.ndarray, cols_w: np.ndarray,
                     batch: int = 100_000) -> dict:
    """The control's readings: the reference's store less the writes
    still queued at the flush barrier, taken as the last batch of each
    capture file's put (a file's entries go in row-then-column order,
    ``batch`` a put as the ingest stage sends them), compared as a
    pass's store is."""
    keep = []
    for rec in recs:
        n = rec.shape[0] * cols_w.shape[1]
        m = np.ones(n, bool)
        m[n - (n % batch or batch):] = False
        keep.append(m)
    keep = np.concatenate(keep)
    r = np.repeat(rows_w, cols_w.shape[1])[keep]
    c = cols_w.ravel()[keep]
    rk, code_r = np.unique(r, return_inverse=True)
    ck, code_c, deg = np.unique(c, return_inverse=True, return_counts=True)
    want_k, want = np.unique(cols_w.ravel(), return_counts=True)
    got = dict(zip(ck.tolist(), deg.tolist()))
    dst = np.char.startswith(ck, "ip.dst|")
    return {"tedge_mismatch": float(store_mismatch(rk, ck, code_r, code_c,
                                                   rows_w, cols_w)),
            "deg_gap": float(max(abs(got.get(k, 0) - v)
                                 for k, v in zip(want_k.tolist(),
                                                 want.tolist()))),
            "fit_rel": C.fit_rel(fit_rank_size(deg[dst]), fit_rank_size(
                want[np.char.startswith(want_k, "ip.dst|")]))}


def _pcap_header() -> bytes:
    hdr = np.zeros(1, dtype=pcap_frozen._GLOBAL_HDR)
    hdr["magic"] = pcap_frozen.PCAP_MAGIC
    hdr["vmaj"], hdr["vmin"] = 2, 4
    hdr["snaplen"] = pcap_frozen.SNAPLEN
    hdr["network"] = pcap_frozen.LINKTYPE_RAW
    return hdr.tobytes()
