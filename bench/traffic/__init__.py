"""Traffic the benchmark offers, made from ``--seed`` by the frozen
generator (:mod:`bench.traffic.pcap_frozen`) and the request-mix
generator (:mod:`bench.traffic.mix`), both driven by the data files of a
configuration and a workload."""
from __future__ import annotations

import numpy as np

from . import pcap_frozen


def traffic_config(cfg: dict, seed: int) -> "pcap_frozen.TrafficConfig":
    return pcap_frozen.TrafficConfig(**cfg["traffic"], seed=int(seed))


def frozen_window(cfg: dict, seed: int):
    """The configuration's window of packets for ``seed``: (records,
    their TSV as the paper's parse stage writes it)."""
    rec = pcap_frozen.synth_packets(traffic_config(cfg, seed),
                                    float(cfg["window_s"]))
    return rec, pcap_frozen.records_to_tsv(rec)


def ranked_hosts(rec: np.ndarray):
    """The window's destinations, most packets first: (dotted quads,
    packet counts)."""
    uniq, counts = np.unique(rec["dst"], return_counts=True)
    order = np.argsort(-counts, kind="stable")
    return pcap_frozen.ip_str(uniq[order]), counts[order]
