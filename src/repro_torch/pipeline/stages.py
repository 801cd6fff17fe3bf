"""The paper's six pipeline stages (§III-B, §IV-A..F), file → file.

Every stage is **idempotent** (outputs written via atomic rename), which
is what makes the runner's straggler re-issue and crash-restart sound:
a re-executed task simply overwrites identical bytes.

Stage semantics mirror the paper exactly:

1. ``uncompress`` — gunzip the raw capture (2 GB → 6 GB per file there;
   compression ratio here depends on the synthetic data).
2. ``split``      — cut the pcap into ~``split_size`` chunks (paper: 5 MB)
   so later stages parallelize; each chunk is a *valid* pcap.
3. ``parse``      — tshark analog: binary pcap → TSV with the paper's
   field set (§III-A listing).
4. ``sort``       — TSV → **dense** associative array; the time field is
   restructured (bucketed to whole seconds) so the exploded schema's
   column space stays bounded; array is saved sorted (construction sorts).
5. ``sparse``     — ``E = val2col(A,'|')``: dense table → incidence matrix.
6. ``ingest``     — ``put(Tedge, putVal(E,'1,'))`` + degree table insert.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
from typing import List, Optional

import numpy as np

from ..core.assoc import Assoc
from ..core.schema import parse_tsv, val2col
from . import pcap as P


@dataclasses.dataclass
class StageResult:
    outputs: List[str]
    bytes_in: int
    bytes_out: int


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


# --------------------------------------------------------------------------
# Stage 0 (setup, not in the paper's count): capture-appliance emulation.
# --------------------------------------------------------------------------

def generate(path: str, cfg: P.TrafficConfig, duration_s: float,
             t0: float = 1_492_000_000.0) -> StageResult:
    rec = P.synth_packets(cfg, duration_s, t0=t0)
    n = P.write_pcap(path, rec, compress=True)
    return StageResult([path], 0, n)


# --------------------------------------------------------------------------
# Stage 1: uncompress  (paper: `system(['gunzip -k ' ... '.pcap.gz'])`)
# --------------------------------------------------------------------------

def uncompress(src: str) -> StageResult:
    assert src.endswith(".pcap.gz"), src
    dst = src[: -len(".gz")]
    with gzip.open(src, "rb") as f:
        data = f.read()
    _atomic_write(dst, data)
    return StageResult([dst], os.path.getsize(src), len(data))


# --------------------------------------------------------------------------
# Stage 2: split  (paper: tcpdump → ~5 MB chunks, split ID appended)
# --------------------------------------------------------------------------

def split(src: str, split_size: int = 5 * 2**20) -> StageResult:
    with open(src, "rb") as f:
        buf = f.read()
    ghdr = buf[: P._GLOBAL_HDR.itemsize]
    body = buf[P._GLOBAL_HDR.itemsize:]
    rec_size = P.REC_DTYPE.itemsize
    per_chunk = max(split_size // rec_size, 1)
    n_rec = len(body) // rec_size
    outputs = []
    total_out = 0
    for j, start in enumerate(range(0, n_rec, per_chunk)):
        chunk = body[start * rec_size:(start + per_chunk) * rec_size]
        dst = f"{src[:-5]}.split{j:05d}.pcap"
        _atomic_write(dst, ghdr + chunk)
        outputs.append(dst)
        total_out += len(ghdr) + len(chunk)
    return StageResult(outputs, len(buf), total_out)


# --------------------------------------------------------------------------
# Stage 3: parse  (tshark analog — binary → TSV, paper's field filter)
# --------------------------------------------------------------------------

def parse(src: str, t0: Optional[float] = None) -> StageResult:
    rec = P.read_pcap(src)
    base = os.path.basename(src)
    tsv = P.records_to_tsv(rec, t0=t0, pkt_prefix=base + "|")
    dst = src + ".tsv"
    _atomic_write(dst, tsv.encode())
    return StageResult([dst], os.path.getsize(src), len(tsv))


# --------------------------------------------------------------------------
# Stage 4: sort — dense associative array construction
# --------------------------------------------------------------------------

def sort_stage(src: str) -> StageResult:
    with open(src, "rb") as f:
        text = f.read().decode()
    A = parse_tsv(text)
    # "restructure the time field": bucket frame.time to whole seconds so
    # the exploded column space stays bounded (near-unique values would
    # otherwise make one column per packet).
    if A.nnz:
        r, c, v = A.triples()
        tmask = c == "frame.time"
        if tmask.any():
            v = v.astype(object)
            secs = np.asarray(
                [f"{float(x):.0f}" for x in v[tmask]], dtype=object)
            v[tmask] = secs
            v = v.astype(str)
        rmask = c == "frame.time_relative"  # drop per-packet-unique field
        A = Assoc(r[~rmask], c[~rmask], v[~rmask])
    dst = src + ".A.npz"
    A.save(dst)
    return StageResult([dst], os.path.getsize(src), os.path.getsize(dst))


# --------------------------------------------------------------------------
# Stage 5: sparse — `E = val2col(A,'|')` (incidence matrix)
# --------------------------------------------------------------------------

def sparse_stage(src: str) -> StageResult:
    A = Assoc.load(src)
    E = val2col(A, "|")
    dst = src[: -len(".npz")] + ".E.npz"
    E.save(dst)
    return StageResult([dst], os.path.getsize(src), os.path.getsize(dst))


# --------------------------------------------------------------------------
# Stage 6: ingest — put(Tedge, putVal(E,'1,')) + degree table
# --------------------------------------------------------------------------

def ingest(src: str, db) -> StageResult:
    from ..db.binding import bind, put

    E = Assoc.load(src)
    # paper: put(Tedge, putVal(E,'1,')) through the D4M binding — batched
    # writers, file→instance routing on multi-instance backends.
    # paper: Edeg = putCol(sum(E.',2),'degree,'); put(TedgeDeg, num2str(Edeg))
    # (the store's sum combiner maintains TedgeDeg during the same put)
    # sync=False: batches enqueue to the backend's writer pool so tablet
    # mutation overlaps the runner's parse/sort tasks; the driver's
    # end-of-DAG flush barrier is the commit point.
    n = put(bind(db), E.putval("1,"), file_id=src, sync=False)
    return StageResult([], os.path.getsize(src), n)
