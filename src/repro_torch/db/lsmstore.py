"""Persistent LSM edge store — a durable Accumulo analog behind ``DB()``.

The in-process :class:`~repro_torch.db.edgestore.EdgeStore` reproduces the
paper's *topology* (tablets, combiners, parallel instances) but not its
*durability*: Accumulo is a persistent sorted store, and the D4M
follow-on work (arXiv:1902.00846's hierarchical in-memory databases,
arXiv:1907.04217's 1.9B updates/sec) wins precisely by layering fast
in-memory tiers over sorted on-disk runs — which is an LSM tree.

:class:`LSMStore` is one instance of that design:

* **write-ahead log** — every mutation batch is framed (CRC-checked)
  and appended to ``wal.log`` before it touches the memtable; replayed
  on open, truncated at the first torn frame, so a crash at any instant
  loses nothing past the last :meth:`sync` (the WriterPool flush
  barrier's commit point);
* **memtable** — the in-memory tier: sorted cell maps for Tedge and
  TedgeT plus the sum-combiner TedgeDeg column family (exactly the
  :class:`~repro_torch.db.edgestore.Tablet` families, minus the sharding);
* **sorted runs** — when the memtable exceeds ``memtable_limit``
  mutations it spills to an immutable SSTable: sorted key records in
  blocks, a sparse block index, and a salted-CRC prefix bloom filter
  (point and prefix scans skip runs that cannot contain the key);
* **compaction** — ``compact()`` (and an automatic trigger at
  ``max_runs``) merges every run combiner-aware: newest run wins per
  cell, degrees *sum* — the Accumulo iterator-stack semantics;
* **recovery** — ``open`` = list runs + replay WAL; reopening after a
  kill reproduces exactly the synced state.

The scan protocol (``scan_keys`` / ``scan_key_range`` / ``scan_prefix``
/ ``scan_everything`` / ``degree`` / ``degree_items`` / ``put_triples``
/ ``put_degree``) matches :class:`EdgeStore`, so ``DB()``, ``LazyAssoc``
planning, ``ScanCache``, and ``WriterPool`` run unchanged on top.
:class:`LSMMultiInstanceDB` shards instances across subdirectories —
the paper's 8×16 parallel-instance topology, durable.
"""
from __future__ import annotations

import bisect
import io
import json
import os
import struct
import threading
import zlib
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from ..core.assoc import Assoc
from ..obs.metrics import REGISTRY as _REGISTRY, obj_label as _obj_label
from ..obs.trace import span as _span, traced_iter as _traced_iter
from .edgestore import MultiInstanceDB, connections_query

# -- WAL framing -------------------------------------------------------------
# frame := magic(1B) kind(1B) len(4B LE) payload crc32(4B LE)
_WAL_MAGIC = 0xD4
_KIND_TRIPLES = 0x01
_KIND_DEGREE = 0x02
_FRAME_HDR = struct.Struct("<BBI")
_FRAME_CRC = struct.Struct("<I")

# -- LSM metric families (one labeled child per live store) ------------------
# The ROADMAP's compaction-hardening item needs these to quantify write
# amplification and stall time; ``n_syncs`` keeps its attribute shape as
# a property over the sync counter.
_M_WAL_APPENDS = _REGISTRY.counter(
    "repro_lsm_wal_appends_total", "WAL frames appended", labels=("store",))
_M_SPILLS = _REGISTRY.counter(
    "repro_lsm_spills_total", "Memtable spills to immutable runs",
    labels=("store",))
_M_COMPACTIONS = _REGISTRY.counter(
    "repro_lsm_compactions_total", "Full-merge compactions",
    labels=("store",))
_M_SYNCS = _REGISTRY.counter(
    "repro_lsm_syncs_total", "WAL fsyncs (durability barriers)",
    labels=("store",))

# -- SSTable layout ----------------------------------------------------------
_SST_FORMAT = 1
_BLOCK_KEYS = 64            # sparse-index granularity (records per block)
_BLOOM_PREFIX_LEN = 8       # chars of key prefix also inserted in the bloom
_BLOOM_BITS_PER_KEY = 10
_BLOOM_HASHES = 4


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed file's entry is durable —
    without this, a power loss could drop a spilled run while keeping
    the subsequent WAL truncation."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return              # platform without directory fds
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _bloom_hashes(key: str, n_bits: int) -> list[int]:
    """k stable hash positions (salted CRC32 — Python's str hash is
    process-salted and must never reach disk)."""
    data = key.encode()
    return [zlib.crc32(data, seed * 0x9E3779B1 + 1) % n_bits
            for seed in range(_BLOOM_HASHES)]


class _Bloom:
    def __init__(self, n_keys: int, bits: Optional[bytearray] = None):
        n_bits = max(8, n_keys * _BLOOM_BITS_PER_KEY)
        self.bits = bits if bits is not None else bytearray((n_bits + 7) // 8)
        self.n_bits = len(self.bits) * 8

    def add(self, key: str) -> None:
        for h in _bloom_hashes(key, self.n_bits):
            self.bits[h >> 3] |= 1 << (h & 7)

    def __contains__(self, key: str) -> bool:
        return all(self.bits[h >> 3] & (1 << (h & 7))
                   for h in _bloom_hashes(key, self.n_bits))

    def hex(self) -> str:
        return self.bits.hex()

    @classmethod
    def from_hex(cls, s: str) -> "_Bloom":
        return cls(0, bytearray.fromhex(s))


class _Memtable:
    """The in-memory tier: Tedge + TedgeT cell maps and the TedgeDeg
    sum-combiner family.  Not thread-safe — the owning store locks."""

    def __init__(self):
        self.edge: dict[str, dict[str, str]] = {}
        self.edge_t: dict[str, dict[str, str]] = {}
        self.deg: defaultdict[str, float] = defaultdict(float)
        self.n_mutations = 0
        self.ingest_bytes = 0

    def apply_triples(self, r: Sequence[str], c: Sequence[str],
                      v: Sequence[str]) -> None:
        for rk, ck, vv in zip(r, c, v):
            self.edge.setdefault(rk, {})[ck] = vv
            self.edge_t.setdefault(ck, {})[rk] = vv
            self.n_mutations += 1
            self.ingest_bytes += len(rk) + len(ck) + len(vv)
        for ck, n in zip(*np.unique(np.asarray(c, dtype=str),
                                    return_counts=True)):
            self.deg[str(ck)] += float(n)

    def apply_degree(self, keys: Sequence[str], counts: Sequence[float]):
        for k, n in zip(keys, counts):
            self.deg[str(k)] += float(n)


class SSTable:
    """One immutable sorted run: per-table sorted records in blocks, a
    sparse (first-key, offset) index per table, and a bloom filter over
    full keys and their ``_BLOOM_PREFIX_LEN``-char prefixes."""

    def __init__(self, path: str):
        self.path = path
        # hold the handle for the run's lifetime: compaction unlinks
        # superseded runs, and POSIX keeps an open fd readable, so a scan
        # that snapshotted this run before a concurrent compact still works
        self._f = open(path, "rb")
        self._io_lock = threading.Lock()
        self._f.seek(-8, os.SEEK_END)
        (footer_off,) = struct.unpack("<Q", self._f.read(8))
        self._f.seek(footer_off)
        footer = json.loads(self._f.read()[:-8].decode())
        if footer.get("format") != _SST_FORMAT:
            raise ValueError(f"{path}: unknown SSTable format")
        self.index: dict[str, list] = footer["index"]   # table → [[key, off]]
        self.blooms = {t: _Bloom.from_hex(h)
                       for t, h in footer["bloom"].items()}
        self.meta = footer["meta"]    # n_mutations, ingest_bytes

    # -- readers -----------------------------------------------------------
    def _read_from(self, table: str, start: str, stop: Optional[str],
                   limit: Optional[int] = None) -> list[tuple]:
        """Records of ``table`` with start <= key (<= stop), beginning at
        the sparse-index block that may contain ``start``."""
        idx = self.index.get(table) or []
        if not idx:
            return []
        firsts = [e[0] for e in idx]
        b = max(bisect.bisect_right(firsts, start) - 1, 0)
        out: list[tuple] = []
        with self._io_lock:
            self._f.seek(idx[b][1])
            for line in self._f:
                if line.startswith(b"#end "):
                    break
                key, payload = json.loads(line.decode())
                if stop is not None and key > stop:
                    break
                if key >= start:
                    out.append((key, payload))
                    if limit is not None and len(out) >= limit:
                        break
        return out

    def scan_range(self, table: str, start: str,
                   stop: Optional[str]) -> list[tuple]:
        """(key, payload) records in the inclusive [start, stop] range
        (``stop=None`` = unbounded)."""
        return self._read_from(table, start, stop)

    def scan_all(self, table: str) -> list[tuple]:
        return self._read_from(table, "", None)

    def get(self, table: str, key: str):
        """Point lookup (bloom-gated, one block touched)."""
        if table in self.blooms and key not in self.blooms[table]:
            return None
        hit = self._read_from(table, key, key, limit=1)
        return hit[0][1] if hit else None

    def may_contain_prefix(self, table: str, prefix: str) -> bool:
        """False only when the bloom proves no key starts with ``prefix``
        (usable when the query prefix covers the indexed prefix length)."""
        bloom = self.blooms.get(table)
        if bloom is None or len(prefix) < _BLOOM_PREFIX_LEN:
            return True
        return prefix[:_BLOOM_PREFIX_LEN] in bloom

    @staticmethod
    def write(path: str, edge: dict, edge_t: dict, deg: dict,
              meta: dict) -> None:
        """Serialize sorted sections + index + bloom; atomic rename and
        fsync so a run either exists completely or not at all."""
        buf = io.BytesIO()
        buf.write(json.dumps({"format": _SST_FORMAT}).encode() + b"\n")
        index: dict[str, list] = {}
        blooms: dict[str, str] = {}
        for table, data in (("edge", edge), ("edgeT", edge_t),
                            ("deg", deg)):
            keys = sorted(data)
            bloom = _Bloom(len(keys))
            entries = []
            for i, k in enumerate(keys):
                if i % _BLOCK_KEYS == 0:
                    entries.append([k, buf.tell()])
                bloom.add(k)
                if len(k) >= _BLOOM_PREFIX_LEN:
                    bloom.add(k[:_BLOOM_PREFIX_LEN])
                buf.write(json.dumps([k, data[k]]).encode() + b"\n")
            buf.write(b"#end " + table.encode() + b"\n")
            index[table] = entries
            blooms[table] = bloom.hex()
        footer_off = buf.tell()
        buf.write(json.dumps({"format": _SST_FORMAT, "index": index,
                              "bloom": blooms, "meta": meta}).encode())
        buf.write(struct.pack("<Q", footer_off))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path) or ".")


class LSMStore:
    """One durable instance: WAL + memtable + sorted runs (see module
    docstring).  Speaks the :class:`EdgeStore` scan protocol."""

    def __init__(self, path: str, name: Optional[str] = None,
                 memtable_limit: int = 200_000, max_runs: int = 8):
        self.path = path
        self.name = name or os.path.basename(os.path.abspath(path)) or "lsm"
        self.memtable_limit = memtable_limit
        self.max_runs = max_runs
        self._lock = threading.RLock()
        self._mem = _Memtable()
        self._runs: list[SSTable] = []
        self._wal_dirty = False
        self.metrics_label = _obj_label("lsm")
        lab = dict(store=self.metrics_label)
        self._m_wal_appends = _M_WAL_APPENDS.labels(**lab)
        self._m_spills = _M_SPILLS.labels(**lab)
        self._m_compactions = _M_COMPACTIONS.labels(**lab)
        self._m_syncs = _M_SYNCS.labels(**lab)
        os.makedirs(path, exist_ok=True)
        for fn in sorted(f for f in os.listdir(path)
                         if f.startswith("run-") and f.endswith(".sst")):
            self._runs.append(SSTable(os.path.join(path, fn)))
        self._next_run = 1 + max(
            [int(os.path.basename(r.path)[4:-4]) for r in self._runs],
            default=0)
        self._wal_path = os.path.join(path, "wal.log")
        self._replay_wal()
        self._wal = open(self._wal_path, "ab")

    # -- WAL ---------------------------------------------------------------
    def _replay_wal(self) -> None:
        """Rebuild the memtable from the log; truncate at the first torn
        or corrupt frame (a crash mid-append leaves exactly that)."""
        if not os.path.exists(self._wal_path):
            return
        good = 0
        with open(self._wal_path, "rb") as f:
            data = f.read()
        off = 0
        while off + _FRAME_HDR.size <= len(data):
            magic, kind, n = _FRAME_HDR.unpack_from(data, off)
            end = off + _FRAME_HDR.size + n + _FRAME_CRC.size
            if magic != _WAL_MAGIC or end > len(data):
                break
            payload = data[off + _FRAME_HDR.size:end - _FRAME_CRC.size]
            (crc,) = _FRAME_CRC.unpack_from(data, end - _FRAME_CRC.size)
            if zlib.crc32(payload) != crc:
                break
            rec = json.loads(payload.decode())
            if kind == _KIND_TRIPLES:
                self._mem.apply_triples(*rec)
            elif kind == _KIND_DEGREE:
                self._mem.apply_degree(*rec)
            good = end
            off = end
        if good < len(data):        # drop the torn tail
            with open(self._wal_path, "r+b") as f:
                f.truncate(good)

    def _wal_append(self, kind: int, record) -> None:
        payload = json.dumps(record).encode()
        self._wal.write(_FRAME_HDR.pack(_WAL_MAGIC, kind, len(payload))
                        + payload + _FRAME_CRC.pack(zlib.crc32(payload)))
        self._wal.flush()           # to the OS; fsync only at sync()
        self._wal_dirty = True
        self._m_wal_appends.inc()

    def _wal_apply(self, kind: int, record, apply) -> None:
        """Append the frame, then apply it to the memtable; roll the WAL
        back if *either* step fails (a torn append — e.g. ENOSPC — or an
        apply error), so a writer-pool retry of the same block cannot
        leave torn or duplicate frames that a later recovery would drop
        or double-count (the degree family is a sum combiner).  Caller
        holds the lock."""
        self._wal.flush()
        wal_off = self._wal.tell()
        try:
            self._wal_append(kind, record)
            apply()
        except BaseException:
            # discard partial frame bytes (buffered and on disk) by
            # reopening at the pre-append offset; best-effort close —
            # its flush may be the very failure we are recovering from
            try:
                self._wal.close()
            except OSError:
                pass
            with open(self._wal_path, "rb+") as f:
                f.truncate(wal_off)
            self._wal = open(self._wal_path, "ab")
            raise

    def sync(self) -> None:
        """fsync the WAL — the durability commit point.  The binding's
        flush barrier (WriterPool.flush) calls this, which is what makes
        "applied at the flush barrier" also mean "survives a crash"."""
        with self._lock:
            if not self._wal_dirty:
                return
            os.fsync(self._wal.fileno())
            self._wal_dirty = False
            self._m_syncs.inc()

    @property
    def n_syncs(self) -> int:
        """WAL fsyncs performed (registry-backed compat shape)."""
        return self._m_syncs.value

    def close(self) -> None:
        with self._lock:
            self.sync()
            self._wal.close()

    # -- ingest (EdgeStore protocol) ---------------------------------------
    def put(self, E: Assoc) -> int:
        r, c, v = E.triples()
        return self.put_triples(r, c, np.asarray(v).astype(str))

    def put_triples(self, r: np.ndarray, c: np.ndarray,
                    v: np.ndarray) -> int:
        cache = getattr(self, "_scan_cache", None)
        if cache is not None:
            cache.note_write(r, c)
        rec = [np.asarray(r, dtype=str).tolist(),
               np.asarray(c, dtype=str).tolist(),
               np.asarray(v, dtype=str).tolist()]
        with self._lock:
            self._wal_apply(_KIND_TRIPLES, rec,
                            lambda: self._mem.apply_triples(*rec))
            if self._mem.n_mutations >= self.memtable_limit:
                self._spill_locked()
        return int(np.asarray(r).shape[0])

    def put_degree(self, Edeg: Assoc) -> int:
        rr, _, vv = Edeg.triples()
        keys = np.asarray(rr, dtype=str)
        counts = np.asarray(vv, dtype=np.float64)
        cache = getattr(self, "_scan_cache", None)
        if cache is not None:
            cache.note_write(np.asarray([], dtype=str), keys)
        rec = [keys.tolist(), counts.tolist()]
        with self._lock:
            self._wal_apply(_KIND_DEGREE, rec,
                            lambda: self._mem.apply_degree(*rec))
        return int(keys.shape[0])

    # -- spill + compaction -------------------------------------------------
    def _spill_locked(self) -> None:
        """Memtable → immutable run; WAL resets only after the run is
        durably on disk (fsync'd file + rename), so no window loses data."""
        mem = self._mem
        if not mem.n_mutations and not mem.deg:
            return
        with _span("lsm.spill", store=self.name, rows=mem.n_mutations):
            self._m_spills.inc()
            path = os.path.join(self.path, f"run-{self._next_run:06d}.sst")
            SSTable.write(path, mem.edge, mem.edge_t, dict(mem.deg),
                          {"n_mutations": mem.n_mutations,
                           "ingest_bytes": mem.ingest_bytes})
            self._next_run += 1
            self._runs.append(SSTable(path))
            self._mem = _Memtable()
            self._wal.close()
            self._wal = open(self._wal_path, "wb")  # truncate: spilled
            self._wal.flush()
            os.fsync(self._wal.fileno())    # persist the truncation — or a
            self._wal_dirty = False         # power loss could resurrect the
                                            # old WAL on top of the new run
        if len(self._runs) > self.max_runs:
            self._compact_locked()

    def spill(self) -> None:
        """Explicit memtable → run spill (tests, shutdown compaction)."""
        with self._lock:
            self._spill_locked()

    def compact(self) -> None:
        """Merge every run into one, combiner-aware: newest wins per
        cell, degrees sum (the Accumulo iterator-stack semantics)."""
        with self._lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        if len(self._runs) <= 1:
            return
        with _span("lsm.compact", store=self.name, runs=len(self._runs)):
            self._m_compactions.inc()
            edge: dict[str, dict[str, str]] = {}
            edge_t: dict[str, dict[str, str]] = {}
            deg: defaultdict[str, float] = defaultdict(float)
            n_mut = n_bytes = 0
            for run in self._runs:          # oldest → newest: newer wins
                for k, cells in run.scan_all("edge"):
                    edge.setdefault(k, {}).update(cells)
                for k, cells in run.scan_all("edgeT"):
                    edge_t.setdefault(k, {}).update(cells)
                for k, d in run.scan_all("deg"):
                    deg[k] += float(d)
                n_mut += run.meta["n_mutations"]
                n_bytes += run.meta["ingest_bytes"]
            path = os.path.join(self.path, f"run-{self._next_run:06d}.sst")
            SSTable.write(path, edge, edge_t, dict(deg),
                          {"n_mutations": n_mut, "ingest_bytes": n_bytes})
            self._next_run += 1
            old = self._runs
            self._runs = [SSTable(path)]
            for run in old:
                os.remove(run.path)

    # -- scans (EdgeStore protocol) ----------------------------------------
    def _section(self, transpose: bool) -> str:
        return "edgeT" if transpose else "edge"

    def _point(self, key: str, table: str, mem_attr: str) -> dict[str, str]:
        """LSM read path for one key: oldest run first, memtable last —
        each tier overwrites the cells of the tier below."""
        with self._lock:
            runs = list(self._runs)
            mem = dict(getattr(self._mem, mem_attr).get(key, {}))
        out: dict[str, str] = {}
        for run in runs:
            cells = run.get(table, key)
            if cells:
                out.update(cells)
        out.update(mem)
        return out

    # scan generators are traced via traced_iter (one span per full
    # consumption — a span can't stay open across generator yields);
    # the *_raw variants are the real scans, also used for internal
    # delegation so one logical scan never records twice.
    def scan_keys(self, keys: Sequence[str], transpose: bool = False):
        return _traced_iter("lsm.scan_keys",
                            self._scan_keys_raw(keys, transpose),
                            store=self.name)

    def _scan_keys_raw(self, keys: Sequence[str], transpose: bool = False):
        table = self._section(transpose)
        uniq = sorted(set(keys))
        with self._lock:    # snapshot, then read/yield outside the lock
            runs = list(self._runs)
            mem_map = self._mem.edge_t if transpose else self._mem.edge
            mem = {k: dict(mem_map[k]) for k in uniq if k in mem_map}
        for key in uniq:
            out: dict[str, str] = {}
            for run in runs:
                cells = run.get(table, key)
                if cells:
                    out.update(cells)
            out.update(mem.get(key, {}))
            if out:
                yield key, out

    def scan_key_range(self, start: str, stop: Optional[str],
                       transpose: bool = False):
        """Inclusive [start, stop] in key order (``stop=None`` =
        unbounded): k-way merge of the memtable and every run, newer
        tiers overwriting per cell."""
        return _traced_iter("lsm.scan_key_range",
                            self._scan_key_range_raw(start, stop, transpose),
                            store=self.name)

    def _scan_key_range_raw(self, start: str, stop: Optional[str],
                            transpose: bool = False):
        import heapq
        table = self._section(transpose)
        with self._lock:
            runs = list(self._runs)
            mem_map = self._mem.edge_t if transpose else self._mem.edge
            mem_items = [(k, dict(mem_map[k]))
                         for k in sorted(mem_map)
                         if k >= start and (stop is None or k <= stop)]
        # tiers ordered oldest → newest; the tier index tie-breaks equal
        # keys in the merge so dict.update applies newest last
        tiers = [run.scan_range(table, start, stop) for run in runs]
        tiers.append(mem_items)

        def tag(tier, i):
            for k, cells in tier:
                yield k, i, cells

        streams = [tag(t, i) for i, t in enumerate(tiers)]
        cur_key, cur_cells = None, None
        for k, _, cells in heapq.merge(*streams, key=lambda e: (e[0], e[1])):
            if k == cur_key:
                cur_cells.update(cells)
            else:
                if cur_key is not None:
                    yield cur_key, cur_cells
                cur_key, cur_cells = k, dict(cells)
        if cur_key is not None:
            yield cur_key, cur_cells

    def scan_prefix(self, prefix: str, transpose: bool = False):
        return _traced_iter("lsm.scan_prefix",
                            self._scan_prefix_raw(prefix, transpose),
                            store=self.name)

    def _scan_prefix_raw(self, prefix: str, transpose: bool = False):
        table = self._section(transpose)
        with self._lock:
            bloom_skip = not any(r.may_contain_prefix(table, prefix)
                                 for r in self._runs)
            if bloom_skip:      # no run can hold the prefix: memtable only
                mem_map = self._mem.edge_t if transpose else self._mem.edge
                items = [(k, dict(mem_map[k])) for k in sorted(mem_map)
                         if k.startswith(prefix)]
        if bloom_skip:
            yield from items
            return
        yield from self._scan_key_range_raw(prefix, prefix + "￿",
                                            transpose=transpose)

    def scan_everything(self, transpose: bool = False):
        # stop=None, not a '￿' sentinel — astral-plane keys sort
        # above any BMP bound and must still appear in full scans
        return _traced_iter("lsm.scan_everything",
                            self._scan_key_range_raw("", None, transpose),
                            store=self.name)

    def keys_with_prefix(self, prefix: str,
                         transpose: bool = True) -> list[str]:
        return [k for k, _ in self.scan_prefix(prefix, transpose=transpose)]

    # -- degree family ------------------------------------------------------
    def degree(self, col_key: str) -> float:
        with self._lock:
            total = self._mem.deg.get(col_key, 0.0)
            runs = list(self._runs)
        for run in runs:
            d = run.get("deg", col_key)
            if d is not None:
                total += float(d)
        return total

    def degree_items(self, prefix: str = ""):
        return _traced_iter("lsm.degree_items",
                            self._degree_items_raw(prefix), store=self.name)

    def _degree_items_raw(self, prefix: str = ""):
        acc: defaultdict[str, float] = defaultdict(float)
        with self._lock:
            for k, d in self._mem.deg.items():
                if not prefix or k.startswith(prefix):
                    acc[k] += d
            runs = list(self._runs)
        for run in runs:
            if prefix and not run.may_contain_prefix("deg", prefix):
                continue
            it = (run.scan_range("deg", prefix, prefix + "￿")
                  if prefix else run.scan_all("deg"))
            for k, d in it:
                acc[k] += float(d)
        yield from acc.items()

    def degree_assoc(self) -> Assoc:
        items = list(self.degree_items())
        if not items:
            return Assoc()
        return Assoc(np.asarray([k for k, _ in items], dtype=str),
                     "degree,",
                     np.asarray([v for _, v in items], dtype=np.float64))

    # -- point queries (EdgeStore compatibility) ---------------------------
    def row(self, row_key: str) -> dict[str, str]:
        return self._point(row_key, "edge", "edge")

    def col(self, col_key: str) -> dict[str, str]:
        return self._point(col_key, "edgeT", "edge_t")

    def connections(self, ip: str, **kw) -> dict[str, float]:
        return connections_query(self, ip, **kw)

    # -- stats --------------------------------------------------------------
    @property
    def n_entries(self) -> int:
        with self._lock:
            return self._mem.n_mutations + sum(
                r.meta["n_mutations"] for r in self._runs)

    @property
    def ingest_bytes(self) -> int:
        with self._lock:
            return self._mem.ingest_bytes + sum(
                r.meta["ingest_bytes"] for r in self._runs)

    @property
    def n_runs(self) -> int:
        return len(self._runs)

    def __repr__(self) -> str:
        return (f"LSMStore({self.path!r}, entries={self.n_entries}, "
                f"runs={self.n_runs}, mem={self._mem.n_mutations})")


class LSMMultiInstanceDB(MultiInstanceDB):
    """M parallel durable instances sharded across subdirectories
    (``<path>/db0 … dbM-1``) — the paper's 8×16 topology with each
    instance owning its own WAL and run set.  Inherits the scan fan-out
    / k-way merge machinery from :class:`MultiInstanceDB`."""

    def __init__(self, path: str, n_instances: int = 8,
                 memtable_limit: int = 200_000, max_runs: int = 8):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.instances = [
            LSMStore(os.path.join(path, f"db{i}"), name=f"db{i}",
                     memtable_limit=memtable_limit, max_runs=max_runs)
            for i in range(n_instances)]

    @staticmethod
    def key_hash(k: str) -> int:
        """Stable routing hash: instance placement is on-disk state, so
        a row must map to the same subdirectory in every process —
        Python's salted ``hash()`` would scatter a key's updates across
        instances between restarts and break last-write-wins."""
        return zlib.crc32(k.encode())

    def sync(self) -> None:
        for inst in self.instances:
            inst.sync()

    def spill(self) -> None:
        for inst in self.instances:
            inst.spill()

    def compact(self) -> None:
        for inst in self.instances:
            inst.compact()

    def close(self) -> None:
        for inst in self.instances:
            inst.close()
