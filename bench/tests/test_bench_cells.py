"""Each cell's run, driven on the CPU at a tiny size past the harness's
look for a card: the program's answers pass, the control's fail, a cell
or metric added as files runs with no code edit, and a run with the
timed path broken underneath comes out not correct."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import control
from bench import run as R
from bench.harness import common

TINY = {
    "gbe-mem.analyst": {"config": {"window_s": 0.04}},
    "gbe-net.mix": {"config": {"window_s": 0.04}},
    "gbe-net.burst": {"config": {"window_s": 0.04}},
    "gbe-mem.pipeline": {"config": {"window_s": 0.04},
                         "workload": {"duration_per_file_s": 0.01}},
}
SECONDS = {"gbe-net.mix": 4.0, "gbe-net.burst": 3.0}


@pytest.fixture
def cpu():
    from repro_torch.device import set_device
    prev = set_device("cpu")
    try:
        yield
    finally:
        set_device(prev)


def tiny_run(cell: str, seed: int = 20231, trace: bool = False):
    """One run of ``cell`` on the CPU at a tiny size; a workload file
    that BENCHMARK.json does not list yet runs under an entry made here."""
    spec = common.benchmark_spec()
    if cell not in [w["name"] for w in spec["workloads"]]:
        wl = common.load_json("workloads", cell)
        spec["workloads"].append({"name": cell, "config": wl["config"],
                                  "traffic": "tiny", "chips": 1,
                                  "why": "a tiny rehearsal"})
    return R.run_cell(cell, seed, SECONDS.get(cell, 1.5), trace,
                      require_cuda=False, spec=spec,
                      overrides=json.loads(json.dumps(TINY[cell])))


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal is for a machine without")
    proc = subprocess.run(
        [sys.executable, str(common.BENCH / "run.py"), "--workload",
         "gbe-mem.analyst", "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(common.SRC)))
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


@pytest.mark.parametrize("cell", sorted(TINY))
def test_program_passes_and_control_fails(cell, cpu):
    run, *_ = tiny_run(cell)
    assert run.correct, [(c.name, c.value) for c in run.checks]
    wl = common.load_json("workloads", cell)
    ctl = control.control_checks(wl, run)
    assert any(v > wl["limits"][k] for k, v in ctl.items()), ctl


def test_traced_run_reads_every_metric_it_lists(cpu):
    run, metrics, device, breakdown = tiny_run("gbe-mem.analyst", trace=True)
    got = {m["name"]: run.metrics.get(m["name"]) for m in metrics}
    # no card here: the device readers find nothing and return nothing
    assert got["planner.lowering_ms"] > 0 and got["db.scan_ms"] >= 0
    assert got["ell_roofline"] is None
    assert device["window_s"] > 0 and set(breakdown) == {"device_ops",
                                                          "idle_gaps"}


def test_added_cell_and_metric_need_no_code_edit(tmp_path):
    """A copy of the benchmark with one more cell and one more per-layer
    metric, each only a file and an entry, runs them."""
    shutil.copytree(common.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = common.benchmark_spec()
    wl = common.load_json("workloads", "gbe-mem.analyst")
    wl.update(name="gbe-mem.analyst-b4", batch_hosts=4)
    (tmp_path / "bench/workloads/gbe-mem.analyst-b4.json").write_text(
        json.dumps(wl))
    (tmp_path / "bench/metrics/planner.calls.py").write_text(
        "def read(run):\n    return float(len(run.layer['spans']))\n")
    spec["workloads"].append({"name": "gbe-mem.analyst-b4",
                              "config": "d4m-gbe-mem", "traffic": "b4",
                              "chips": 1, "why": "four hosts a batch"})
    for m in spec["end_to_end"]:
        if "gbe-mem.analyst" in m.get("workloads", []):
            m["workloads"].append("gbe-mem.analyst-b4")
    spec["per_layer"].append({"name": "planner.calls", "unit": "calls",
                              "better": "higher", "source": "program_span",
                              "layer": "core.expr", "moves": "requests_per_s",
                              "workloads": ["gbe-mem.analyst-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from bench import run as R\n"
        "out = {}\n"
        "for trace in (False, True):\n"
        "    run, m, *_ = R.run_cell('gbe-mem.analyst-b4', 3, 1.0, trace,\n"
        "        require_cuda=False,\n"
        "        overrides={'config': {'window_s': 0.04}})\n"
        "    out[trace] = ([x['name'] for x in m], run.correct,\n"
        "                  run.metrics.get('planner.calls'))\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(common.SRC),
                                   REPRO_TORCH_DEVICE="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    names, ok, _ = out["false"]
    assert ok and "requests_per_s" in names and "setup_s" in names
    names, ok, calls = out["true"]
    assert ok and "planner.calls" in names and calls > 0


# -- faults planted under the timed path ------------------------------------

def _altered_spmm(mp):
    """An answer altered where it is produced: the batch kernel's first
    output element off by one."""
    from repro_torch.kernels import spmm
    orig = spmm.spmm_ell

    def bad(*a, **k):
        out = orig(*a, **k).clone()
        out.view(-1)[out.view(-1).nonzero()[0]] += 1.0
        return out
    mp.setattr(spmm, "spmm_ell", bad)


def _half_batch(mp):
    """Half of the batch left out: the fused chains evaluate the first
    half's vectors and hand those answers to the rest as well."""
    from repro_torch.core import expr
    orig = expr._device_matmul_chain_multi

    def bad(factors, vecs):
        h = max(len(vecs) // 2, 1)
        outs = orig(factors, vecs[:h])
        return None if outs is None else [outs[i % h] for i in
                                          range(len(vecs))]
    mp.setattr(expr, "_device_matmul_chain_multi", bad)


def _state_unchanged(mp):
    """A step that returns its state unchanged: PageRank's iterations
    leave the starting vector as it was."""
    from repro_torch.analytics import distributed
    orig = distributed.pagerank_sharded
    mp.setattr(distributed, "pagerank_sharded",
               lambda adj, mesh=None, num_iters=20, **k:
               orig(adj, mesh, num_iters=0, **k))


def _altered_topk(mp):
    """An answer altered where it is produced: /v1/topk's first degree
    off by one."""
    from repro_torch.serve import routes
    key = ("GET", "/v1/topk")
    rt = routes.ROUTES[key]

    def bad(gw, req):
        out = rt.handler(gw, req)
        if out["hosts"]:
            out["hosts"][0]["degree"] += 1.0
        return out
    mp.setitem(routes.ROUTES, key, routes.Route(bad, cost=rt.cost,
                                                pattern=rt.pattern))


def _half_coalesced(mp):
    """Half of a coalesced batch left out: the leader evaluates the first
    half's queries and hands their answers to the rest."""
    from repro_torch.serve.coalesce import QueryCoalescer
    orig = QueryCoalescer._run

    def bad(self, batch):
        h = max(len(batch) // 2, 1)
        orig(self, batch[:h])
        for i, p in enumerate(batch[h:]):
            p.result, p.error = batch[i % h].result, batch[i % h].error
            p.done.set()
    mp.setattr(QueryCoalescer, "_run", bad)


def _half_ingest(mp):
    """Half of each ingest batch left out of the store."""
    from repro_torch.core.assoc import Assoc
    from repro_torch.pipeline import stages
    orig = stages.ingest

    def bad(src, db):
        E = Assoc.load(src)
        r, c, v = E.triples()
        n = r.shape[0] // 2
        half = Assoc(r[:n], c[:n], np.ones(n))
        path = src[:-len(".npz")] + ".half.npz"
        half.save(path)
        return orig(path, db)
    mp.setattr(stages, "ingest", bad)


@pytest.mark.parametrize("cell,fault", [
    ("gbe-mem.analyst", _altered_spmm),
    ("gbe-mem.analyst", _half_batch),
    ("gbe-mem.analyst", _state_unchanged),
    ("gbe-net.mix", _altered_topk),
    ("gbe-net.burst", _half_coalesced),
    ("gbe-mem.pipeline", _half_ingest),
], ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(cell, fault, cpu, monkeypatch):
    fault(monkeypatch)
    run, *_ = tiny_run(cell)
    assert not run.correct, [(c.name, c.value) for c in run.checks]
