"""The reference agrees with a window of four packets worked by hand,
and the comparisons read what they should."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from bench.reference import compare as C
from bench.reference.d4m import Window, degree_histogram, fit_rank_size, \
    pipeline_window, store_mismatch
from bench.traffic.pcap_frozen import REC_DTYPE

A, B, Cc = 0x0A000001, 0x0A000002, 0x0A000003     # 10.0.0.1, .2, .3
T0 = 1_492_000_000


def four_packets() -> np.ndarray:
    """A->B :80 at 0 s, C->B :80 at 0.5 s, A->B :6667 at 1 s, B->C :443
    at 1 s."""
    rec = np.zeros(4, REC_DTYPE)
    rec["src"] = [A, Cc, A, B]
    rec["dst"] = [B, B, B, Cc]
    rec["dport"] = [80, 80, 6667, 443]
    rec["sport"] = [40000, 40001, 40002, 40003]
    rec["ts_sec"] = [T0, T0, T0 + 1, T0 + 1]
    rec["ts_usec"] = [0, 500000, 0, 0]
    rec["orig_len"] = [40, 104, 60, 40]
    rec["proto"] = [6, 6, 6, 17]
    rec["off_flags"] = [0x5010, 0x5010, 0x5018, 0x5010]
    return rec


def test_degrees_and_chains():
    w = Window(four_packets())
    keys, deg = w.degrees("ip.dst|")
    assert keys.tolist() == ["10.0.0.2", "10.0.0.3"] and deg.tolist() == [3, 1]
    keys, deg = w.degrees("ip.src|")
    assert deg.tolist() == [2, 1, 1]
    idx, v = w.indicator_chain("10.0.0.2")
    assert idx.tolist() == [0, 1, 2, 3] and v.tolist() == [1, 1, 1, 1]
    idx, v = w.indicator_chain("10.0.0.1")
    assert idx.tolist() == [0, 2]
    assert w.degree_chain()[1].tolist() == [3, 3, 3, 1]
    assert w.scan_col("ip.dst|10.0.0.2").tolist() == [
        "000000000", "000000001", "000000002"]


def test_c2_scores_by_hand():
    w = Window(four_packets())
    hosts, s = w.c2_scores()
    # B: fan-in 2, seen in all 3 time keys evenly, ports 80 x2 + 6667
    # C: fan-in 1, 1 of 3 time keys, one port
    assert hosts.tolist() == ["10.0.0.2", "10.0.0.3"]
    assert s[0] == pytest.approx(math.log(3) * 1.0 * (5 / 9) ** 2)
    assert s[1] == pytest.approx(math.log(2) * (1 / 3) * 1.0)


def test_pagerank_one_step_by_hand():
    nodes, r = Window(four_packets()).pagerank(1)
    assert nodes.tolist() == ["10.0.0.1", "10.0.0.2", "10.0.0.3"]
    assert r == pytest.approx([0.05, 0.05 + 0.85 * 2 / 3,
                               0.05 + 0.85 / 3])


def test_fit_through_two_points():
    f = fit_rank_size([1.0, 3.0])
    assert f["alpha"] == pytest.approx(math.log(3) / math.log(2))
    assert f["log_c"] == pytest.approx(math.log(3))
    assert f["r2"] == pytest.approx(1.0)
    # log1p(1) = 0.693 and log1p(3) = 1.386 over 4 bins of 1.386 / 4
    assert degree_histogram([1.0, 3.0], 4).tolist() == [0, 1, 0, 1]


def test_bfloat16_rounds_large_counts():
    w = Window(np.repeat(four_packets(), 201))       # B's degree 603
    exact = w.degree_chain()[1]
    low = w.degree_chain(torch.bfloat16)[1]
    assert exact.max() == 603 and np.abs(low - exact).max() > 0


def test_pipeline_store_by_hand():
    rows, cols, keys, deg = pipeline_window([four_packets()], 2)
    assert rows.tolist() == [
        "capture0000.split00000.pcap|000000000",
        "capture0000.split00000.pcap|000000001",
        "capture0000.split00001.pcap|000000000",
        "capture0000.split00001.pcap|000000001"]
    assert cols[0].tolist() == [
        f"frame.time|{T0}", "ip.dst|10.0.0.2", "ip.len|40", "ip.proto|6",
        "ip.src|10.0.0.1", "tcp.dstport|80", "tcp.flags|0x00005010",
        "tcp.srcport|40000"]
    assert cols[1][0] == f"frame.time|{T0}"      # 0.5 s rounds to even
    got = dict(zip(keys.tolist(), deg.tolist()))
    assert got["ip.dst|10.0.0.2"] == 3 and got["tcp.flags|0x00005010"] == 3
    rk, code_r = np.unique(np.repeat(rows, 8), return_inverse=True)
    ck, code_c = np.unique(cols.ravel(), return_inverse=True)
    assert store_mismatch(rk, ck, code_r, code_c, rows, cols) == 0
    assert store_mismatch(rk, ck, code_r[:-1], code_c[:-1], rows, cols) == 1


def test_comparisons():
    assert C.column_gap((np.array([0, 2]), np.array([1.0, 2.0])),
                        (np.array([0, 1]), np.array([1.0, 5.0]))) == 5.0
    keys = np.array(["a", "b", "c"])
    scores = np.array([3.0, 2.0, 2.0])
    assert C.ranking(["a", "c"], [3.0, 2.0], keys, scores, 2) == 0.0
    assert C.ranking(["b", "a"], [2.0, 3.0], keys, scores, 2) == \
        pytest.approx(1 / 3)
    assert C.ranking(["a", "b"], [3.0, 2.5], keys, scores, 2) == \
        pytest.approx(0.5 / 3)
    assert C.ranking(["z", "a"], [1, 1], keys, scores, 2) == 1.0
    assert C.vector_rel((keys, np.ones(3)), (keys[::-1], np.ones(3))) == 1.0
    assert C.keyed_gap(["a", "q"], [1.0, 4.0], {"a": 1.0}) == 4.0
