"""Frozen copy of the packet generator and libpcap codec.

Copied verbatim (code below this docstring) from
``src/repro_torch/pipeline/pcap.py`` at commit
a897cbcf57db933d5cd5b4978c4bd7d258c18c54.  It is part of the
benchmark's yardstick: the traffic every cell offers is made here from
``--seed``, so a later change to the program's generator cannot change
what the benchmark measures.  Later PRs of the program do not edit this
file; ``bench/tests/test_bench_traffic.py`` shows that the two still
give the same bytes at a small size, and a PR that changes the
program's generator leaves this copy as it is.

Traffic model: Zipf-popular destinations over ``n_hosts`` addresses,
exponential inter-arrivals at ``pkt_rate``, heavy-tailed lengths, and an
injected botnet beaconing one C2 host on ``c2_port``.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Iterator, Optional

import numpy as np

PCAP_MAGIC = 0xA1B2C3D4
LINKTYPE_RAW = 101  # bare IP — 40-byte headers as in the paper
SNAPLEN = 40        # header capture only, like MAWI header traces

_GLOBAL_HDR = np.dtype([
    ("magic", "<u4"), ("vmaj", "<u2"), ("vmin", "<u2"),
    ("thiszone", "<i4"), ("sigfigs", "<u4"),
    ("snaplen", "<u4"), ("network", "<u4"),
])

# pcap record header (little-endian) + IPv4 + TCP headers (big-endian wire)
REC_DTYPE = np.dtype([
    ("ts_sec", "<u4"), ("ts_usec", "<u4"),
    ("incl_len", "<u4"), ("orig_len", "<u4"),
    ("ver_ihl", "u1"), ("tos", "u1"), ("tot_len", ">u2"),
    ("ip_id", ">u2"), ("frag", ">u2"),
    ("ttl", "u1"), ("proto", "u1"), ("ip_csum", ">u2"),
    ("src", ">u4"), ("dst", ">u4"),
    ("sport", ">u2"), ("dport", ">u2"),
    ("seq", ">u4"), ("ack", ">u4"),
    ("off_flags", ">u2"), ("win", ">u2"),
    ("tcp_csum", ">u2"), ("urg", ">u2"),
])
assert REC_DTYPE.itemsize == 16 + 40


@dataclasses.dataclass
class TrafficConfig:
    n_hosts: int = 4096
    zipf_a: float = 1.3            # popularity exponent (power-law background)
    pkt_rate: float = 100_000.0    # packets/s (paper: 10 GbE ≈ >100k pkt/s)
    tcp_fraction: float = 0.9
    # botnet injection
    n_bots: int = 24
    beacon_period_s: float = 30.0
    beacon_jitter_s: float = 0.5
    c2_port: int = 6667
    seed: int = 0


def _ip_pool(n_hosts: int, rng: np.random.Generator) -> np.ndarray:
    """Random public-looking IPv4 addresses as uint32."""
    ips = rng.integers(0x0B000000, 0xDF000000, size=n_hosts, dtype=np.uint64)
    return np.unique(ips.astype(np.uint32))


def synth_packets(cfg: TrafficConfig, duration_s: float,
                  t0: float = 1_492_000_000.0) -> np.ndarray:
    """Generate a time-sorted structured record array of packet headers."""
    rng = np.random.default_rng(cfg.seed)
    pool = _ip_pool(cfg.n_hosts, rng)
    n = max(int(cfg.pkt_rate * duration_s), 16)

    # --- background traffic: Zipf-popular destinations, uniform-ish sources
    ranks = np.arange(1, pool.shape[0] + 1, dtype=np.float64)
    pop = ranks ** (-cfg.zipf_a)
    pop /= pop.sum()
    dst = rng.choice(pool, size=n, p=pop)
    src = rng.choice(pool, size=n, p=np.roll(pop, pool.shape[0] // 3))
    # avoid self-talk
    same = src == dst
    src[same] = np.roll(src[same], 1) if same.sum() > 1 else pool[0]

    ts = t0 + np.sort(rng.uniform(0.0, duration_s, size=n))
    length = np.minimum(
        40 + rng.pareto(1.2, size=n).astype(np.int64) * 64, 1500)
    proto = np.where(rng.random(n) < cfg.tcp_fraction, 6, 17).astype(np.uint8)
    sport = rng.integers(1024, 65535, size=n, dtype=np.uint32).astype(np.uint16)
    well_known = np.asarray([80, 443, 53, 22, 25, 8080], dtype=np.uint16)
    dport = well_known[rng.integers(0, well_known.shape[0], size=n)]
    flags = np.full(n, 0x5010, dtype=np.uint16)  # data_off=5, ACK

    # --- botnet: bots beacon the C2 host periodically on c2_port.
    # Drawn from an independent RNG stream so botnet_truth() can replay it.
    rng_bot = np.random.default_rng([cfg.seed, 0xB07])
    c2 = pool[rng_bot.integers(0, pool.shape[0])]
    bots = rng_bot.choice(pool[pool != c2], size=cfg.n_bots, replace=False)
    beat_times, beat_src = [], []
    for b in bots:
        t = rng_bot.uniform(0, cfg.beacon_period_s)
        while t < duration_s:
            beat_times.append(t0 + t)
            beat_src.append(b)
            t += cfg.beacon_period_s + rng_bot.normal(0, cfg.beacon_jitter_s)
    nb = len(beat_times)
    if nb:
        ts = np.concatenate([ts, np.asarray(beat_times)])
        src = np.concatenate([src, np.asarray(beat_src, dtype=np.uint32)])
        dst = np.concatenate([dst, np.full(nb, c2, dtype=np.uint32)])
        length = np.concatenate([length, np.full(nb, 60)])
        proto = np.concatenate([proto, np.full(nb, 6, np.uint8)])
        sport = np.concatenate(
            [sport, rng.integers(40000, 50000, nb).astype(np.uint16)])
        dport = np.concatenate(
            [dport, np.full(nb, cfg.c2_port, dtype=np.uint16)])
        flags = np.concatenate([flags, np.full(nb, 0x5018, np.uint16)])  # PSH|ACK

    order = np.argsort(ts, kind="stable")
    rec = np.zeros(ts.shape[0], dtype=REC_DTYPE)
    rec["ts_sec"] = ts[order].astype(np.uint64).astype(np.uint32)
    rec["ts_usec"] = ((ts[order] % 1.0) * 1e6).astype(np.uint32)
    rec["incl_len"] = SNAPLEN
    rec["orig_len"] = length[order]
    rec["ver_ihl"] = 0x45
    rec["tot_len"] = np.minimum(length[order], 65535)
    rec["ttl"] = 64
    rec["proto"] = proto[order]
    rec["src"] = src[order]
    rec["dst"] = dst[order]
    rec["sport"] = sport[order]
    rec["dport"] = dport[order]
    rec["off_flags"] = flags[order]
    rec["win"] = 65535
    return rec


def write_pcap(path: str, rec: np.ndarray, compress: bool = False) -> int:
    """Serialize records to a real libpcap file (optionally .gz)."""
    hdr = np.zeros(1, dtype=_GLOBAL_HDR)
    hdr["magic"] = PCAP_MAGIC
    hdr["vmaj"], hdr["vmin"] = 2, 4
    hdr["snaplen"] = SNAPLEN
    hdr["network"] = LINKTYPE_RAW
    payload = hdr.tobytes() + rec.tobytes()
    opener = gzip.open if compress else open
    tmp = path + ".tmp"
    with opener(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)  # atomic — idempotent under task re-issue
    return len(payload)


def read_pcap(path: str) -> np.ndarray:
    """Parse a libpcap file back into the structured record array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        buf = f.read()
    hdr = np.frombuffer(buf[:_GLOBAL_HDR.itemsize], dtype=_GLOBAL_HDR)[0]
    if hdr["magic"] != PCAP_MAGIC:
        raise ValueError(f"{path}: bad pcap magic {hdr['magic']:#x}")
    if hdr["network"] != LINKTYPE_RAW or hdr["snaplen"] != SNAPLEN:
        raise ValueError(f"{path}: unsupported linktype/snaplen")
    body = buf[_GLOBAL_HDR.itemsize:]
    if len(body) % REC_DTYPE.itemsize:
        body = body[: len(body) - len(body) % REC_DTYPE.itemsize]
    return np.frombuffer(body, dtype=REC_DTYPE)


def ip_str(ip_u32: np.ndarray) -> np.ndarray:
    """Vectorized uint32 → dotted-quad strings."""
    ip = np.asarray(ip_u32, dtype=np.uint32)
    a = (ip >> 24) & 0xFF
    b = (ip >> 16) & 0xFF
    c = (ip >> 8) & 0xFF
    d = ip & 0xFF
    out = np.char.add(np.char.add(a.astype("U3"), "."), b.astype("U3"))
    out = np.char.add(np.char.add(out, "."), c.astype("U3"))
    return np.char.add(np.char.add(out, "."), d.astype("U3"))


# paper §III-A listing — the tshark field set we extract
TSV_FIELDS = ("frame.time_relative", "frame.time", "ip.dst", "ip.len",
              "ip.proto", "ip.src", "tcp.dstport", "tcp.flags", "tcp.srcport")


def records_to_tsv(rec: np.ndarray, t0: Optional[float] = None,
                   pkt_prefix: str = "") -> str:
    """tshark analog: binary records → TSV with the paper's field set."""
    if rec.shape[0] == 0:
        return "id\t" + "\t".join(TSV_FIELDS) + "\n"
    ts = rec["ts_sec"].astype(np.float64) + rec["ts_usec"] * 1e-6
    if t0 is None:
        t0 = float(ts[0])
    rel = ts - t0
    cols = {
        "frame.time_relative": np.char.mod("%.9f", rel),
        "frame.time": np.char.mod("%.6f", ts),
        "ip.dst": ip_str(rec["dst"]),
        "ip.len": rec["orig_len"].astype("U6"),
        "ip.proto": rec["proto"].astype("U3"),
        "ip.src": ip_str(rec["src"]),
        "tcp.dstport": rec["dport"].astype("U5"),
        "tcp.flags": np.asarray([f"0x{x:08x}" for x in rec["off_flags"]]),
        "tcp.srcport": rec["sport"].astype("U5"),
    }
    ids = np.char.add(pkt_prefix,
                      np.char.zfill(np.arange(rec.shape[0]).astype("U9"), 9))
    body = ids
    for f in TSV_FIELDS:
        body = np.char.add(np.char.add(body, "\t"), cols[f])
    return "id\t" + "\t".join(TSV_FIELDS) + "\n" + "\n".join(body) + "\n"


def botnet_truth(cfg: TrafficConfig) -> dict:
    """Recompute the injected C2/bot identities (deterministic in seed) —
    the ground truth the analytics layer is validated against."""
    pool = _ip_pool(cfg.n_hosts, np.random.default_rng(cfg.seed))
    rng_bot = np.random.default_rng([cfg.seed, 0xB07])
    c2 = pool[rng_bot.integers(0, pool.shape[0])]
    bots = rng_bot.choice(pool[pool != c2], size=cfg.n_bots, replace=False)
    return {
        "c2": str(ip_str(np.asarray([c2]))[0]),
        "bots": [str(s) for s in ip_str(bots)],
        "c2_port": cfg.c2_port,
    }
