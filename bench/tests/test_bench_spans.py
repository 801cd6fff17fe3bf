"""The analyst's traced window on the CPU at a tiny size: the readers of
the planner's executor, the analytics and the ScanCache find their
spans, and in the two longest calls the spans below the planner's
``planner.eval``/``planner.eval_batch`` and the analytics' spans name
nearly all of the call's time."""
from __future__ import annotations

import pytest

from bench import run as R
from bench.harness.spans import self_seconds

UNNAMED = ("planner.eval", "planner.eval_batch")


@pytest.fixture(scope="module")
def traced():
    from repro_torch.device import set_device
    prev = set_device("cpu")
    try:
        run, metrics, *_ = R.run_cell(
            "gbe-mem.analyst", 20231, 1.5, True, require_cuda=False,
            overrides={"config": {"window_s": 0.04}})
    finally:
        set_device(prev)
    return run, {m["name"] for m in metrics}


def test_new_readers_read(traced):
    run, listed = traced
    assert {"planner.exec_ms", "analytics.host_ms",
            "db.scan_cache_hit_pct"} <= listed
    assert run.metrics["planner.exec_ms"] > 0
    assert run.metrics["analytics.host_ms"] > 0
    assert 0 <= run.metrics["db.scan_cache_hit_pct"] <= 100


@pytest.mark.parametrize("kind", ["pagerank_table", "detect_c2"])
def test_spans_name_the_call(traced, kind):
    """Self time of every span but the call's root and the planner's
    entry points, over the calls' time: at least 85%."""
    run, _ = traced
    named = total = 0.0
    for (k, *_), spans in zip(run.layer["done"], run.layer["spans"]):
        if k != kind:
            continue
        own = self_seconds(spans)
        for s in spans:
            if s["parent_id"] == 0:
                total += s["dur_s"]
            elif s["name"] not in UNNAMED:
                named += own[s["span_id"]]
    assert total > 0
    assert named / total >= 0.85, (kind, named / total)
