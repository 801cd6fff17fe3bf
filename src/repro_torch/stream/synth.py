"""Synthetic traffic scenario harness — reproducible streams with truth.

Every streaming detector in this package is benchmarked against *known*
ground truth: a scenario is a seeded mix of diurnal background traffic
plus injected attacks (C2 beaconing, port/host scans, DDoS bursts), and
:func:`synth_scenario` returns both the packet records and the labels —
which hosts attacked whom, over exactly which window.  The records are
the same ``REC_DTYPE`` structured arrays the pipeline's pcap codec
produces (``repro_torch.pipeline.pcap``), so a scenario can be written to a
real libpcap file, run through the batch pipeline, or streamed
block-by-block into async ingest with :func:`stream_blocks`.

Background model (as in ``pcap.synth_packets``): Zipf-popular
destinations over a seeded host pool, well-known service ports, TCP-
dominated — but with the arrival rate modulated by a **diurnal load
curve** ``rate(t) = base_rate · (1 + amplitude · sin(2πt/period))``, the
slow non-stationarity the SPC detectors must *not* alarm on.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from ..core.assoc import Assoc
from ..core.schema import parse_tsv, val2col
from ..pipeline.pcap import REC_DTYPE, _ip_pool, ip_str, records_to_tsv

_WELL_KNOWN = np.asarray([80, 443, 53, 22, 25, 8080], dtype=np.uint16)


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """One injected attack.  ``kind`` selects the traffic shape:

    * ``'c2'`` — ``n_hosts`` bots beacon one C2 server every ``period_s``
      (± ``jitter_s``) on ``port`` for the whole window;
    * ``'scan'`` — one attacker touches ``rate`` fresh destinations per
      second, one SYN each (logical fan-out ≈ packet fan-out);
    * ``'ddos'`` — ``n_hosts`` attackers flood one victim at ``rate``
      packets/s *each* on ``port``.
    """
    kind: str                   # 'c2' | 'scan' | 'ddos'
    start: float                # seconds from scenario start
    duration: float
    n_hosts: int = 6
    rate: float = 50.0
    period_s: float = 5.0
    jitter_s: float = 0.1
    port: int = 6667


@dataclasses.dataclass
class ScenarioConfig:
    """A seeded scenario mix: diurnal background + injected attacks."""
    duration_s: float = 120.0
    n_hosts: int = 128
    base_rate: float = 150.0        # mean background packets/s
    diurnal_amplitude: float = 0.3
    diurnal_period_s: float = 600.0  # a compressed "day"
    zipf_a: float = 1.3
    tcp_fraction: float = 0.9
    seed: int = 0
    t0: float = 1_492_000_000.0
    attacks: Tuple[AttackSpec, ...] = ()


def _background(cfg: ScenarioConfig, rng: np.random.Generator):
    """Diurnal background: per-second Poisson counts around the load
    curve, Zipf-popular destinations, service-port mix."""
    secs = np.arange(int(np.ceil(cfg.duration_s)))
    lam = cfg.base_rate * (
        1.0 + cfg.diurnal_amplitude *
        np.sin(2 * np.pi * secs / cfg.diurnal_period_s))
    counts = rng.poisson(np.maximum(lam, 1.0))
    n = int(counts.sum())
    ts = cfg.t0 + np.repeat(secs.astype(np.float64), counts) \
        + rng.uniform(0.0, 1.0, size=n)

    pool = _ip_pool(cfg.n_hosts, rng)
    ranks = np.arange(1, pool.shape[0] + 1, dtype=np.float64)
    pop = ranks ** (-cfg.zipf_a)
    pop /= pop.sum()
    dst = rng.choice(pool, size=n, p=pop)
    src = rng.choice(pool, size=n, p=np.roll(pop, pool.shape[0] // 3))
    same = src == dst
    src[same] = np.roll(src[same], 1) if same.sum() > 1 else pool[0]

    length = np.minimum(
        40 + rng.pareto(1.2, size=n).astype(np.int64) * 64, 1500)
    proto = np.where(rng.random(n) < cfg.tcp_fraction, 6, 17) \
        .astype(np.uint8)
    sport = rng.integers(1024, 65535, size=n).astype(np.uint16)
    dport = _WELL_KNOWN[rng.integers(0, _WELL_KNOWN.shape[0], size=n)]
    flags = np.full(n, 0x5010, dtype=np.uint16)     # data_off=5, ACK
    return pool, dict(ts=ts, src=src, dst=dst, length=length, proto=proto,
                      sport=sport, dport=dport, flags=flags)


def _attack_packets(cfg: ScenarioConfig, spec: AttackSpec, idx: int,
                    pool: np.ndarray) -> tuple[dict, dict]:
    """(packet columns, truth label) for one injected attack.  Each
    attack draws from its own RNG stream so labels are replayable."""
    rng = np.random.default_rng([cfg.seed, 0xA77, idx])
    lo, hi = cfg.t0 + spec.start, cfg.t0 + spec.start + spec.duration

    if spec.kind == "c2":
        c2 = pool[rng.integers(0, pool.shape[0])]
        bots = rng.choice(pool[pool != c2], size=spec.n_hosts,
                          replace=False)
        ts, src = [], []
        for b in bots:
            t = lo + rng.uniform(0, spec.period_s)
            while t < hi:
                ts.append(t)
                src.append(b)
                t += spec.period_s + rng.normal(0, spec.jitter_s)
        n = len(ts)
        cols = dict(
            ts=np.asarray(ts), src=np.asarray(src, np.uint32),
            dst=np.full(n, c2, np.uint32),
            length=np.full(n, 60), proto=np.full(n, 6, np.uint8),
            sport=rng.integers(40000, 50000, n).astype(np.uint16),
            dport=np.full(n, spec.port, np.uint16),
            flags=np.full(n, 0x5018, np.uint16))          # PSH|ACK
        truth = {"kind": "c2", "attackers": [str(s) for s in ip_str(bots)],
                 "victim": str(ip_str(np.asarray([c2]))[0])}

    elif spec.kind == "scan":
        attacker = pool[rng.integers(0, pool.shape[0])]
        n = max(int(spec.rate * spec.duration), 1)
        # fresh targets outside the pool: every probe hits a new host
        targets = rng.integers(0x0B000000, 0xDF000000, size=n,
                               dtype=np.uint64).astype(np.uint32)
        cols = dict(
            ts=np.sort(rng.uniform(lo, hi, size=n)),
            src=np.full(n, attacker, np.uint32), dst=targets,
            length=np.full(n, 40), proto=np.full(n, 6, np.uint8),
            sport=rng.integers(40000, 60000, n).astype(np.uint16),
            dport=rng.integers(1, 1024, n).astype(np.uint16),
            flags=np.full(n, 0x5002, np.uint16))          # SYN
        truth = {"kind": "scan",
                 "attackers": [str(ip_str(np.asarray([attacker]))[0])],
                 "victim": ""}

    elif spec.kind == "ddos":
        victim = pool[rng.integers(0, pool.shape[0])]
        attackers = rng.choice(pool[pool != victim], size=spec.n_hosts,
                               replace=False)
        per = rng.poisson(spec.rate * spec.duration, size=spec.n_hosts)
        n = int(per.sum())
        cols = dict(
            ts=rng.uniform(lo, hi, size=n),
            src=np.repeat(attackers, per).astype(np.uint32),
            dst=np.full(n, victim, np.uint32),
            length=np.full(n, 60), proto=np.full(n, 6, np.uint8),
            sport=rng.integers(1024, 65535, n).astype(np.uint16),
            dport=np.full(n, spec.port if spec.port != 6667 else 80,
                          np.uint16),
            flags=np.full(n, 0x5010, np.uint16))
        truth = {"kind": "ddos",
                 "attackers": [str(s) for s in ip_str(attackers)],
                 "victim": str(ip_str(np.asarray([victim]))[0])}
    else:
        raise ValueError(f"unknown attack kind {spec.kind!r}")

    truth.update(start=lo, stop=hi, port=int(spec.port),
                 n_packets=int(cols["ts"].shape[0]))
    return cols, truth


def synth_scenario(cfg: ScenarioConfig
                   ) -> tuple[np.ndarray, dict]:
    """Generate the scenario: a time-sorted ``REC_DTYPE`` record array
    plus the ground-truth label dict ``{"attacks": [...], ...}``."""
    rng = np.random.default_rng(cfg.seed)
    pool, cols = _background(cfg, rng)
    labels = []
    for i, spec in enumerate(cfg.attacks):
        acols, truth = _attack_packets(cfg, spec, i, pool)
        labels.append(truth)
        for k in cols:
            cols[k] = np.concatenate([cols[k], acols[k]])

    order = np.argsort(cols["ts"], kind="stable")
    n = order.shape[0]
    rec = np.zeros(n, dtype=REC_DTYPE)
    ts = cols["ts"][order]
    rec["ts_sec"] = ts.astype(np.uint64).astype(np.uint32)
    rec["ts_usec"] = ((ts % 1.0) * 1e6).astype(np.uint32)
    rec["incl_len"] = 40
    rec["orig_len"] = cols["length"][order]
    rec["ver_ihl"] = 0x45
    rec["tot_len"] = np.minimum(cols["length"][order], 65535)
    rec["ttl"] = 64
    rec["proto"] = cols["proto"][order]
    rec["src"] = cols["src"][order]
    rec["dst"] = cols["dst"][order]
    rec["sport"] = cols["sport"][order]
    rec["dport"] = cols["dport"][order]
    rec["off_flags"] = cols["flags"][order]
    rec["win"] = 65535
    truth = {"t0": cfg.t0, "duration_s": cfg.duration_s, "seed": cfg.seed,
             "attacks": labels}
    return rec, truth


def scenario_truth(cfg: ScenarioConfig) -> dict:
    """Just the labels (deterministic in the seed; regenerates)."""
    return synth_scenario(cfg)[1]


def records_to_incidence(rec: np.ndarray, t0: float,
                         pkt_prefix: str = "p") -> Assoc:
    """Records → sparse incidence Assoc via the stage 4→5 schema path
    (tshark-analog TSV → dense table → ``val2col`` explosion)."""
    return val2col(parse_tsv(records_to_tsv(rec, t0=t0,
                                            pkt_prefix=pkt_prefix)))


def scenario_incidence(cfg: ScenarioConfig) -> tuple[Assoc, dict]:
    """Whole scenario as one incidence matrix (the batch-ingest shape)."""
    rec, truth = synth_scenario(cfg)
    return records_to_incidence(rec, cfg.t0), truth


def stream_blocks(cfg: ScenarioConfig, block_s: float = 1.0,
                  rec: Optional[np.ndarray] = None
                  ) -> Iterator[tuple[float, Assoc]]:
    """Stream the scenario as ``(block_start_ts, incidence)`` pairs, one
    per ``block_s`` of traffic — the shape async ingest consumes.
    Packet ids are prefixed per block so rows stay globally unique."""
    if rec is None:
        rec, _ = synth_scenario(cfg)
    ts = rec["ts_sec"].astype(np.float64) + rec["ts_usec"] * 1e-6
    n_blocks = int(np.ceil(cfg.duration_s / block_s)) + 1
    for i in range(n_blocks):
        lo = cfg.t0 + i * block_s
        m = (ts >= lo) & (ts < lo + block_s)
        if not m.any():
            continue
        yield lo, records_to_incidence(rec[m], cfg.t0,
                                       pkt_prefix=f"b{i:06d}-p")
