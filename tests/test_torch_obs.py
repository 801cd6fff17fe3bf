"""The port's tracing: the untraced path stays a shared no-op, the
planner's executor and the analytics record the span tree that the
benchmark's readers (``planner.exec_ms``, ``analytics.host_ms``,
``db.scan_cache_hit_pct``) read, and a live span mirrors into a running
``torch.profiler``."""
import numpy as np
import pytest
import torch

from repro_torch.analytics import detect_c2
from repro_torch.analytics.distributed import pagerank_table
from repro_torch.core import Assoc, eval_batch, lazy
from repro_torch.core import expr as X
from repro_torch.core.keys import StartsWith
from repro_torch.db import DB, put
from repro_torch.device import set_device
from repro_torch.obs import Tracer, span
from repro_torch.obs import trace as TR


@pytest.fixture(autouse=True)
def _cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def packets(n=400, hosts=12, seed=3) -> Assoc:
    """An incidence array in the pipeline's layout: one row a packet,
    columns ``field|value`` holding 1."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        p = f"pkt{i:05d}"
        fields = (f"ip.src|10.0.0.{rng.integers(hosts)}",
                  f"ip.dst|10.0.1.{rng.integers(hosts)}",
                  f"frame.time|{i // 40:04d}",
                  f"tcp.dstport|{rng.choice([80, 443, 6667])}")
        rows.extend([p] * len(fields))
        cols.extend(fields)
    return Assoc(np.asarray(rows), np.asarray(cols), np.ones(len(rows)))


@pytest.fixture
def table():
    T = DB("Tedge", "TedgeT", "TedgeDeg", cache_ttl=600.0)
    put(T, packets())
    T.flush()
    return T


def small(seed, n=30, nnz=120, ncols=None):
    rng = np.random.default_rng(seed)
    ncols = ncols or n
    return Assoc(np.asarray([f"v{i:03d}" for i in rng.integers(0, n, nnz)]),
                 np.asarray([f"v{i:03d}" for i in rng.integers(0, ncols,
                                                               nnz)]),
                 rng.integers(1, 4, nnz).astype(np.float64))


def vector(seed, n=30):
    keys = np.asarray([f"v{i:03d}" for i in range(0, n, 3)])
    return Assoc(keys, np.asarray(["x"] * keys.shape[0]),
                 np.arange(1.0, keys.shape[0] + 1))


def traced(fn):
    """Run ``fn`` under a fresh root span; its flat span records."""
    tr = Tracer(max_spans=4096)
    root = tr.start("q")
    with root:
        fn()
    return tr.spans(root.trace_id)


def tree(spans):
    """(name, [children...]) from the root down, children by start."""
    kids = {}
    for s in sorted(spans, key=lambda s: s["start"]):
        kids.setdefault(s["parent_id"], []).append(s)

    def node(s):
        return (s["name"], [node(c) for c in kids.get(s["span_id"], [])])
    (root,) = kids[0]
    return node(root)


def named(spans, name):
    return [s for s in spans if s["name"] == name]


# -- the untraced path --------------------------------------------------------

def test_untraced_span_is_the_shared_noop():
    sp = span("planner.exec.matmul", nnz=1)
    assert sp is TR._NOOP and not sp.live
    with sp as inner:
        inner.tag(nnz=2)            # a no-op, and no error


def test_untraced_eval_records_nothing(table, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a live span was built with no trace open")
    monkeypatch.setattr(TR, "_Span", refuse)
    out = (table[:, StartsWith("ip.src|")].T
           * table[:, StartsWith("ip.dst|")]).eval()
    assert out.nnz > 0


# -- the executor's span tree -------------------------------------------------

def test_product_of_two_scans_span_tree(table):
    spans = traced(lambda: (table[:, StartsWith("ip.src|")].T
                            * table[:, StartsWith("ip.dst|")]).eval())
    assert tree(spans) == (
        "q", [("planner.eval", [
            ("planner.exec.matmul", [
                ("planner.exec.transpose", [
                    ("planner.exec.scan", [("db.scan", [])])]),
                ("planner.exec.scan", [("db.scan", [])]),
                ("planner.exec.align", [])])])])
    (mm,) = named(spans, "planner.exec.matmul")
    assert mm["tags"]["route"] == "host"
    for s in spans:
        if s["name"].startswith("planner.exec.") and s["name"] != \
                "planner.exec.align":
            assert s["tags"]["nnz"] >= 0 and len(s["tags"]["shape"]) == 2


@pytest.mark.parametrize("route,threshold,build,kernel", [
    ("host", 10 ** 9, lambda: lazy(small(1)) * lazy(small(2)), None),
    ("spmv", 1, lambda: lazy(small(1)) * lazy(vector(3)), "kernel.spmv"),
    ("chain", 1, lambda: lazy(small(1)) * lazy(small(2)) * lazy(vector(3)),
     "kernel.spmv"),
])
def test_matmul_route_tag(route, threshold, build, kernel, monkeypatch):
    monkeypatch.setattr(X, "DEVICE_NNZ_THRESHOLD", threshold)
    spans = traced(lambda: build().eval())
    top = [s for s in named(spans, "planner.exec.matmul")
           if s["parent_id"] == named(spans, "planner.eval")[0]["span_id"]]
    assert [s["tags"]["route"] for s in top] == [route]
    inside = {s["name"] for s in spans if s["parent_id"] == top[0]["span_id"]}
    assert "planner.exec.align" in inside
    if kernel is not None:
        assert kernel in inside


@pytest.mark.parametrize("route,threshold", [("host", 10 ** 9),
                                             ("device", 1)])
def test_sum_route_tag(route, threshold, monkeypatch):
    monkeypatch.setattr(X, "DEVICE_NNZ_THRESHOLD", threshold)
    spans = traced(lambda: lazy(small(4)).sum(1).eval())
    assert [s["tags"]["route"] for s in named(spans, "planner.exec.sum")] \
        == [route]


def test_fused_chain_tags_its_ops():
    spans = traced(lambda: ((lazy(small(5)) * 2.0).logical() > 0).eval())
    (f,) = named(spans, "planner.exec.fused")
    assert f["tags"]["ops"] == ["scale", "logical", "filter"]


@pytest.mark.parametrize("case", ["memo_hit", "value_set"])
def test_a_node_run_once_records_one_span(case):
    """Leaves record nothing; a memo hit and a node evaluated before
    record no second span."""
    a = lazy(small(6))
    if case == "memo_hit":
        spans = traced(lambda: (a.T + a.T).eval())
        want = ["planner.eval", "planner.exec.add", "planner.exec.transpose",
                "q"]
    else:
        t = a.T
        t.eval()                                # untraced: _value set
        spans = traced(lambda: (t + lazy(small(7))).eval())
        want = ["planner.eval", "planner.exec.add", "q"]
    assert sorted(s["name"] for s in spans) == want


# -- the analytics -----------------------------------------------------------

@pytest.mark.parametrize("call,phases", [
    (lambda T: pagerank_table(T, num_iters=5),
     ["analytics.pagerank_table", "analytics.pagerank.adjacency",
      "analytics.pagerank.square", "analytics.pagerank.upload",
      "analytics.pagerank.iterate"]),
    (lambda T: detect_c2(T, top_k=3),
     ["analytics.c2_scores", "analytics.c2.fanin", "analytics.c2.uniform",
      "analytics.c2.beacon", "analytics.c2.ports", "analytics.c2.fuse"]),
], ids=["pagerank_table", "detect_c2"])
def test_analytics_record_their_phases(call, phases, table):
    spans = traced(lambda: call(table))
    got = [s["name"] for s in sorted(spans, key=lambda s: s["start"])
           if s["name"].startswith("analytics.")]
    assert got == phases
    (top,) = named(spans, phases[0])
    kids = {s["name"] for s in spans if s["parent_id"] == top["span_id"]}
    assert kids == set(phases[1:])
    # every product the analytics make runs under one of their phases (a
    # planner.eval may nest: the planner forces a rewritten child to
    # compare it with the original)
    by_id = {s["span_id"]: s for s in spans}
    for ev in named(spans, "planner.eval"):
        parent = by_id[ev["parent_id"]]["name"]
        assert parent in phases[1:] or parent == "planner.eval"


def test_scan_batch_tags_hits_and_misses(table):
    def batch():
        eval_batch([table[:, f"ip.dst|10.0.1.{h},"] for h in (1, 2, 3)])
    first = traced(batch)
    second = traced(batch)
    (b1,), (b2,) = named(first, "db.scan_batch"), named(second,
                                                        "db.scan_batch")
    assert (b1["tags"]["hits"], b1["tags"]["misses"]) == (0, 3)
    assert (b2["tags"]["hits"], b2["tags"]["misses"]) == (3, 0)


# -- the profiler's clock -----------------------------------------------------

def test_spans_mirror_into_a_running_profiler(table):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced(lambda: (table[:, StartsWith("ip.src|")].T
                        * table[:, StartsWith("ip.dst|")]).eval())
    names = {e.name for e in prof.events()}
    assert {"q", "planner.eval", "planner.exec.matmul",
            "planner.exec.align", "db.scan"} <= names


def test_no_profiler_no_record_function(table, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    spans = traced(lambda: (table[:, StartsWith("ip.src|")].T
                            * table[:, StartsWith("ip.dst|")]).eval())
    assert named(spans, "planner.exec.matmul")


def test_profiler_stopped_inside_a_span():
    """A span opened while the profiler records and closed after it has
    stopped leaves the profiler's range without error."""
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    root = tr.start("q")
    with root:
        with span("inner"):
            prof.__exit__(None, None, None)
    assert [s["name"] for s in tr.spans(root.trace_id)] == ["inner", "q"]
