"""The frozen generator gives the same bytes as the program's at a small
size, and the request-mix generator gives every seed the same sizes."""
from __future__ import annotations

import gzip

import numpy as np
import pytest

from bench.traffic import mix, pcap_frozen


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
def test_frozen_generator_matches_the_program(seed, tmp_path):
    from repro_torch.pipeline import pcap
    kw = dict(n_hosts=64, pkt_rate=2000.0, n_bots=4, beacon_period_s=0.05,
              beacon_jitter_s=0.001, seed=seed)
    ours = pcap_frozen.synth_packets(pcap_frozen.TrafficConfig(**kw), 0.2,
                                     t0=1_492_000_003.0)
    theirs = pcap.synth_packets(pcap.TrafficConfig(**kw), 0.2,
                                t0=1_492_000_003.0)
    assert ours.tobytes() == theirs.tobytes()
    assert pcap_frozen.records_to_tsv(ours, pkt_prefix="f|") == \
        pcap.records_to_tsv(theirs, pkt_prefix="f|")
    pcap_frozen.write_pcap(str(tmp_path / "a.pcap.gz"), ours, compress=True)
    pcap.write_pcap(str(tmp_path / "b.pcap.gz"), theirs, compress=True)
    with gzip.open(tmp_path / "a.pcap.gz") as a, \
            gzip.open(tmp_path / "b.pcap.gz") as b:
        assert a.read() == b.read()
    assert pcap_frozen.botnet_truth(pcap_frozen.TrafficConfig(**kw)) == \
        pcap.botnet_truth(pcap.TrafficConfig(**kw))


WL = {"arrivals": {"rate_per_s": 6.0}, "burst": 1, "mix": [
    {"route": "topk", "share": 0.4,
     "params": {"prefix": ["ip.dst|", "ip.src|"], "k": [10, 50]}},
    {"route": "scan", "share": 0.3,
     "params": {"field": "ip.dst", "max_cells": 100}},
    {"route": "c2", "share": 0.3, "params": {"top_k": [3, 4]}}]}


def _sizes(reqs):
    return (sorted(round(b["due"] - a["due"], 9)
                   for a, b in zip(reqs, reqs[1:])),
            sorted(r["path"] for r in reqs))


def test_every_seed_gets_the_same_sizes_in_another_order():
    hosts = np.asarray([f"10.0.0.{i}" for i in range(20)])
    counts = np.arange(20, 0, -1)
    a = mix.schedule(WL, 1, 10.0, hosts, counts)
    b = mix.schedule(WL, 2, 10.0, hosts, counts)
    assert len(a) == len(b) == 60
    assert [r["path"] for r in a] != [r["path"] for r in b]
    assert sorted(r["path"] for r in a) == sorted(r["path"] for r in b)
    ga, gb = (np.append(np.diff([r["due"] for r in x]),
                        10.0 - x[-1]["due"]) for x in (a, b))
    assert np.allclose(np.sort(ga), np.sort(gb), atol=1e-9)
    assert a == mix.schedule(WL, 1, 10.0, hosts, counts)
    routes = [r["route"] for r in a]
    assert routes.count("topk") == 24 and routes.count("scan") == 18


def test_bursts_share_one_due_time():
    wl = dict(WL, burst=8, hot_hosts=4, arrivals={"rate_per_s": 2.0})
    hosts = np.asarray([f"10.0.0.{i}" for i in range(20)])
    reqs = mix.schedule(wl, 3, 5.0, hosts, np.arange(20, 0, -1))
    assert len(reqs) == 80
    for i in range(0, 80, 8):
        assert len({r["due"] for r in reqs[i:i + 8]}) == 1
    scanned = {r["params"]["key"] for r in reqs if r["route"] == "scan"}
    assert len(scanned) <= 4


def test_a_route_may_send_single_requests_in_a_bursty_mix():
    wl = {"arrivals": {"rate_per_s": 10.0}, "burst": 8, "mix": [
        {"route": "topk", "share": 0.9, "params": {"prefix": "ip.dst|",
                                                   "k": 10}},
        {"route": "degree", "share": 0.1, "burst": 1,
         "params": {"prefix": "ip.dst|", "bins": 32}}]}
    hosts = np.asarray(["10.0.0.1"])
    reqs = mix.schedule(wl, 4, 2.0, hosts, np.ones(1))
    routes = [r["route"] for r in reqs]
    assert routes.count("degree") == 2 and routes.count("topk") == 18 * 8
