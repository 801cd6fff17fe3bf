"""Networked shard backend — the paper's topology, finally over a wire.

Everything before this module scales *inside* one process: the binding,
planner, cache, and WriterPool all run against in-process stores.  The
paper's headline result is topological — parallel Accumulo tablet
servers fed by independent D4M writer processes — and its follow-ons
push the same shape to 8×16 instance grids (arXiv:1902.00846) and
1.9B updates/s of streaming ingest (arXiv:1907.04217).  This module is
that shape: shard *servers* each owning a durable
:class:`~repro_torch.db.lsmstore.LSMStore` (or a volatile
:class:`~repro_torch.db.edgestore.EdgeStore`), and a *client* backend that
speaks the full EdgeStore scan protocol so ``DBTable``, ``LazyAssoc``
planning, the :class:`~repro_torch.db.binding.ScanCache`, and the
:class:`~repro_torch.db.writer.WriterPool` run on it completely unchanged.

Wire protocol — length-prefixed frames over TCP::

    frame   := magic(0xD5, 1B) | len(4B LE) | payload(len bytes)
    payload := JSON array
    request := [op, kwargs]
    reply   := ["ok", result]           one frame   (unary ops)
             | ["chunk", items]*        then
               ["end", null]                        (streaming scans)
             | ["err", type, message]               (op raised)

Design notes, each previously proven by the orphaned ``BENCH_net.json``
experiment:

* **batched puts** — one RPC per coalesced WriterPool block (the pool's
  tier-2 drain already concatenates everything queued), 10–35x over
  naive per-put RPCs;
* **chunked streaming scans** — servers stream ``chunk`` frames of
  ``chunk_items`` records, so a full-table scan never materializes on
  either side and the client's k-way instance merge
  (:meth:`MultiInstanceDB._merged`) stays streaming end-to-end;
* **sync barrier** — :meth:`NetMultiInstanceDB.sync` fans out to every
  shard whose client saw a write since the last barrier (per-shard
  dirty gate) and the server fsyncs its WAL; a clean barrier is a pure
  client-side check (~µs), which matters because *every* binding read
  issues a flush;
* **failover** — a dead shard surfaces as :class:`ConnectionError` from
  the RPC; the WriterPool's bounded-backoff retry path re-dials on each
  attempt (a restarted shard server picks the block up), and a shard
  that stays dead propagates a clear
  :class:`~repro_torch.db.writer.AsyncWriterError` at the next barrier.

Delivery is at-least-once under retry (Accumulo BatchWriter semantics):
edge cells are last-write-wins so replays are idempotent; a retried
block whose first attempt died *after* the server applied it can
double-count degree sums — the same caveat Accumulo's combiner
documents.

Run a standalone shard server with::

    python -m repro_torch.db.netstore --port 9101 --path /data/shard0

and bind the cluster with ``DB(..., backend="net",
addresses=["host:9101", ...])``.  With no ``addresses``,
``DB(..., backend="net", n_instances=4)`` auto-starts that many local
in-process servers (LSM-backed under ``path``, volatile otherwise) —
the single-node topology tests and benchmarks use.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import zlib
from typing import Iterable, Optional, Sequence

import numpy as np

from ..core.assoc import Assoc
from ..obs.metrics import REGISTRY as _REGISTRY, obj_label as _obj_label
from ..obs.trace import span as _span, traced_iter as _traced_iter
from .edgestore import EdgeStore, MultiInstanceDB, connections_query

_MAGIC = 0xD5
_HDR = struct.Struct("<BI")
_MAX_FRAME = 1 << 30            # 1 GiB sanity bound on a length prefix

DEFAULT_CHUNK_ITEMS = 512       # records per streamed scan frame

# Client-side RPC metric families.  Children are labeled with both the
# shard address and a per-client id, so two clients dialing the same
# shard (e.g. across rebinds in one process) never merge counts — the
# ``n_rpcs`` compat property must read back only its own.  Replaces the
# unsynchronized ``self.n_rpcs += 1`` that concurrent reader threads
# used to race on.
_M_RPCS = _REGISTRY.counter(
    "repro_rpc_total", "Completed shard RPCs (client side)",
    labels=("shard", "client"))
_M_RPC_BYTES = _REGISTRY.counter(
    "repro_rpc_bytes_total",
    "Framed RPC bytes on the wire (client side), by direction",
    labels=("shard", "client", "dir"))


class ShardError(RuntimeError):
    """The shard server's op raised; message carries the remote error."""


# ---------------------------------------------------------------------------
# Framing.
# ---------------------------------------------------------------------------

def _send_frame(sock: socket.socket, obj) -> int:
    """Send one frame; returns its size on the wire (header + payload)."""
    payload = json.dumps(obj).encode()
    buf = _HDR.pack(_MAGIC, len(payload)) + payload
    sock.sendall(buf)
    return len(buf)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """n bytes or None on clean EOF; raises on a torn read mid-frame."""
    chunks = []
    got = 0
    while got < n:
        b = sock.recv(min(n - got, 1 << 20))
        if not b:
            if got:
                raise ConnectionError("connection closed mid-frame")
            return None
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def _recv_frame_sized(sock: socket.socket):
    """(decoded payload, wire bytes), or (None, 0) on clean EOF between
    frames — the sized variant the client's byte counters use."""
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None, 0
    magic, n = _HDR.unpack(hdr)
    if magic != _MAGIC or n > _MAX_FRAME:
        raise ConnectionError(f"bad frame header (magic={magic:#x}, len={n})")
    payload = _recv_exact(sock, n)
    if payload is None:
        raise ConnectionError("connection closed mid-frame")
    return json.loads(payload.decode()), _HDR.size + n


def _recv_frame(sock: socket.socket):
    """Decoded payload, or None on clean EOF between frames."""
    return _recv_frame_sized(sock)[0]


# ---------------------------------------------------------------------------
# Server.
# ---------------------------------------------------------------------------

_STREAM_OPS = ("scan_keys", "scan_key_range", "scan_prefix",
               "scan_everything", "degree_items")


class ShardServer:
    """One shard: a TCP accept loop over a store speaking the EdgeStore
    scan protocol (one handler thread per connection; the store's own
    locks provide consistency).  ``port=0`` binds an ephemeral port —
    read it back from :attr:`address`."""

    def __init__(self, store, host: str = "127.0.0.1", port: int = 0,
                 chunk_items: int = DEFAULT_CHUNK_ITEMS):
        self.store = store
        self.chunk_items = chunk_items
        self._sock = socket.create_server((host, port))
        # poll the listener: a thread blocked in accept() is not reliably
        # woken by close() from stop(), and a 5 s join stall per shard
        # would dominate every backend teardown
        self._sock.settimeout(0.25)
        self.host, self.port = self._sock.getsockname()[:2]
        self.address = f"{self.host}:{self.port}"
        self._stopped = threading.Event()
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ShardServer":
        self._thread = threading.Thread(
            target=self._accept_loop, name=f"shard/{self.address}",
            daemon=True)
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return              # listener closed by stop()
            with self._conns_lock:
                if self._stopped.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name=f"shard/{self.address}/conn",
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(None)   # accepted conns inherit the poll
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while True:
                try:
                    req = _recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                if req is None:
                    return
                op, kw = req
                try:
                    self._dispatch(conn, op, kw or {})
                except (BrokenPipeError, ConnectionError, OSError):
                    return
                except Exception as e:  # op failed: report, keep serving
                    try:
                        _send_frame(conn, ["err", type(e).__name__, str(e)])
                    except OSError:
                        return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn: socket.socket, op: str, kw: dict) -> None:
        store = self.store
        if op in _STREAM_OPS:
            self._stream(conn, getattr(store, op)(**kw))
        elif op == "put_triples":
            n = store.put_triples(np.asarray(kw["r"], dtype=str),
                                  np.asarray(kw["c"], dtype=str),
                                  np.asarray(kw["v"], dtype=str))
            _send_frame(conn, ["ok", n])
        elif op == "put_degree":
            n = store.put_degree(Assoc(
                np.asarray(kw["keys"], dtype=str), "degree,",
                np.asarray(kw["counts"], dtype=np.float64)))
            _send_frame(conn, ["ok", n])
        elif op == "degree":
            _send_frame(conn, ["ok", store.degree(kw["col_key"])])
        elif op == "keys_with_prefix":
            _send_frame(conn, ["ok", list(store.keys_with_prefix(**kw))])
        elif op == "row":
            _send_frame(conn, ["ok", store.row(kw["row_key"])])
        elif op == "col":
            _send_frame(conn, ["ok", store.col(kw["col_key"])])
        elif op == "connections":
            _send_frame(conn, ["ok", connections_query(store, **kw)])
        elif op == "sync":
            sync = getattr(store, "sync", None)
            if sync is not None:
                sync()
            _send_frame(conn, ["ok", None])
        elif op == "n_entries":
            _send_frame(conn, ["ok", store.n_entries])
        elif op == "ping":
            _send_frame(conn, ["ok", "pong"])
        else:
            _send_frame(conn, ["err", "ValueError", f"unknown op {op!r}"])

    def _stream(self, conn: socket.socket, it: Iterable) -> None:
        chunk: list = []
        for item in it:
            k, v = item
            chunk.append([k, v])
            if len(chunk) >= self.chunk_items:
                _send_frame(conn, ["chunk", chunk])
                chunk = []
        if chunk:
            _send_frame(conn, ["chunk", chunk])
        _send_frame(conn, ["end", None])

    def stop(self, close_store: bool = False) -> None:
        """Stop serving: close the listener and every live connection
        (in-flight RPCs fail on the client as :class:`ConnectionError` —
        the failover tests kill shards this way).  ``close_store`` also
        closes the store (a durable store fsyncs on close)."""
        self._stopped.set()
        try:    # poke the listener so a blocked accept() observes the stop
            with socket.create_connection((self.host, self.port),
                                          timeout=0.5):
                pass
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        if close_store:
            close = getattr(self.store, "close", None)
            if close is not None:
                close()

    def __repr__(self) -> str:
        return f"ShardServer({self.address}, {type(self.store).__name__})"


# ---------------------------------------------------------------------------
# Client.
# ---------------------------------------------------------------------------

class ShardClient:
    """One shard's client: the EdgeStore scan/write protocol over framed
    RPCs.  Unary ops use a small pool of persistent connections (one
    in-flight request per connection); each streaming scan holds its own
    connection so a long scan never blocks concurrent puts, and an
    abandoned scan generator just discards its socket.

    Connections are (re-)dialed lazily per attempt, so the WriterPool's
    bounded-backoff retry path doubles as failover: a restarted shard
    server picks up the retried block, a shard that stays dead raises
    :class:`ConnectionError` until the pool gives up and surfaces
    :class:`~repro_torch.db.writer.AsyncWriterError` at the barrier.

    ``io_timeout`` bounds each wait for a reply frame once connected
    (``None``, the default, waits as long as the shard takes); a shard
    that stalls past it fails the RPC as :class:`ConnectionError`."""

    def __init__(self, address: str, name: Optional[str] = None,
                 connect_timeout: float = 5.0,
                 io_timeout: Optional[float] = None):
        host, _, port = address.rpartition(":")
        self.address = address
        self.host, self.port = host, int(port)
        self.name = name or f"shard@{address}"
        self.connect_timeout = connect_timeout
        self.io_timeout = io_timeout
        self._pool: list[socket.socket] = []
        self._pool_lock = threading.Lock()
        self._closed = False
        # dirty gate: sync() only pays the RPC when this client wrote
        # since the last barrier — every binding read flushes, and a
        # clean barrier must stay ~µs (pure client-side check)
        self._dirty = False
        # RPC counters live in the process registry (atomic — reader
        # threads scan concurrently); n_rpcs below reads them back
        self.metrics_label = _obj_label("client")
        self._m_rpcs = _M_RPCS.labels(shard=address,
                                      client=self.metrics_label)
        self._m_tx = _M_RPC_BYTES.labels(shard=address,
                                         client=self.metrics_label,
                                         dir="tx")
        self._m_rx = _M_RPC_BYTES.labels(shard=address,
                                         client=self.metrics_label,
                                         dir="rx")

    @property
    def n_rpcs(self) -> int:
        """Completed RPCs (unary replies + finished scan streams)."""
        return self._m_rpcs.value

    # -- connection pool ---------------------------------------------------
    def _dial(self) -> socket.socket:
        try:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.connect_timeout)
        except OSError as e:
            raise ConnectionError(
                f"shard {self.name} at {self.address} unreachable: {e}"
            ) from e
        s.settimeout(self.io_timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _acquire(self) -> socket.socket:
        if self._closed:
            raise ConnectionError(f"shard client {self.name} is closed")
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return self._dial()

    def _release(self, s: socket.socket) -> None:
        with self._pool_lock:
            if not self._closed:
                self._pool.append(s)
                return
        s.close()

    @staticmethod
    def _discard(s: socket.socket) -> None:
        try:
            s.close()
        except OSError:
            pass

    # -- RPC core ----------------------------------------------------------
    def _rpc(self, op: str, **kw):
        with _span(f"rpc.{op}", shard=self.address):
            s = self._acquire()
            try:
                self._m_tx.inc(_send_frame(s, [op, kw]))
                reply, nbytes = _recv_frame_sized(s)
            except (ConnectionError, OSError) as e:
                self._discard(s)
                raise ConnectionError(
                    f"shard {self.name} at {self.address} failed during "
                    f"{op}: {e}") from e
            if reply is None:
                self._discard(s)
                raise ConnectionError(
                    f"shard {self.name} at {self.address} closed the "
                    f"connection during {op}")
            self._release(s)
            self._m_rx.inc(nbytes)
            self._m_rpcs.inc()
            status, *rest = reply
            if status == "err":
                raise ShardError(f"{self.name}: {rest[0]}: {rest[1]}")
            return rest[0]

    def _stream(self, op: str, **kw):
        """One traced span covers the stream's whole consumption (first
        ``next`` to exhaustion or abandonment) — spans can't be held
        open across generator suspensions, so :func:`traced_iter`
        records against the consumer's context instead."""
        return _traced_iter(f"rpc.{op}", self._stream_raw(op, **kw),
                            shard=self.address)

    def _stream_raw(self, op: str, **kw):
        s = self._acquire()
        try:
            try:
                self._m_tx.inc(_send_frame(s, [op, kw]))
                while True:
                    reply, nbytes = _recv_frame_sized(s)
                    if reply is None:
                        raise ConnectionError(
                            f"shard {self.name} at {self.address} closed "
                            f"the connection during {op}")
                    self._m_rx.inc(nbytes)
                    status, payload = reply[0], reply[1:]
                    if status == "end":
                        self._m_rpcs.inc()
                        self._release(s)
                        return
                    if status == "err":
                        self._release(s)
                        raise ShardError(
                            f"{self.name}: {payload[0]}: {payload[1]}")
                    for k, v in payload[0]:
                        yield k, v
            except (ConnectionError, OSError) as e:
                self._discard(s)
                if isinstance(e, ConnectionError):
                    raise
                raise ConnectionError(
                    f"shard {self.name} at {self.address} failed during "
                    f"{op}: {e}") from e
        except GeneratorExit:
            # abandoned mid-stream: the connection still carries frames —
            # never return it to the pool
            self._discard(s)
            raise

    # -- EdgeStore write protocol ------------------------------------------
    def put(self, E: Assoc) -> int:
        r, c, v = E.triples()
        return self.put_triples(r, c, np.asarray(v).astype(str))

    def put_triples(self, r, c, v) -> int:
        cache = getattr(self, "_scan_cache", None)
        if cache is not None:   # client-side eviction, before the RPC
            cache.note_write(np.asarray(r, dtype=str),
                             np.asarray(c, dtype=str))
        self._dirty = True
        return int(self._rpc("put_triples",
                             r=np.asarray(r, dtype=str).tolist(),
                             c=np.asarray(c, dtype=str).tolist(),
                             v=np.asarray(v, dtype=str).tolist()))

    def put_degree(self, Edeg: Assoc) -> int:
        rr, _, vv = Edeg.triples()
        keys = np.asarray(rr, dtype=str)
        cache = getattr(self, "_scan_cache", None)
        if cache is not None:
            cache.note_write(np.asarray([], dtype=str), keys)
        self._dirty = True
        return int(self._rpc("put_degree", keys=keys.tolist(),
                             counts=np.asarray(vv, np.float64).tolist()))

    def sync(self) -> None:
        """Durability barrier for *this client's* writes: no-op when
        clean, else one RPC that fsyncs the shard's WAL."""
        if not self._dirty:
            return
        self._rpc("sync")
        self._dirty = False

    # -- EdgeStore scan protocol -------------------------------------------
    def scan_keys(self, keys: Sequence[str], transpose: bool = False):
        yield from self._stream("scan_keys",
                                keys=[str(k) for k in keys],
                                transpose=transpose)

    def scan_key_range(self, start: str, stop: Optional[str],
                       transpose: bool = False):
        yield from self._stream("scan_key_range", start=start, stop=stop,
                                transpose=transpose)

    def scan_prefix(self, prefix: str, transpose: bool = False):
        yield from self._stream("scan_prefix", prefix=prefix,
                                transpose=transpose)

    def scan_everything(self, transpose: bool = False):
        yield from self._stream("scan_everything", transpose=transpose)

    def degree_items(self, prefix: str = ""):
        for k, v in self._stream("degree_items", prefix=prefix):
            yield k, float(v)

    def keys_with_prefix(self, prefix: str,
                         transpose: bool = True) -> list[str]:
        return list(self._rpc("keys_with_prefix", prefix=prefix,
                              transpose=transpose))

    def degree(self, col_key: str) -> float:
        return float(self._rpc("degree", col_key=col_key))

    def row(self, row_key: str) -> dict[str, str]:
        return self._rpc("row", row_key=row_key)

    def col(self, col_key: str) -> dict[str, str]:
        return self._rpc("col", col_key=col_key)

    def connections(self, ip: str, **kw) -> dict[str, float]:
        return {k: float(v)
                for k, v in self._rpc("connections", ip=ip, **kw).items()}

    def degree_assoc(self) -> Assoc:
        items = list(self.degree_items())
        if not items:
            return Assoc()
        return Assoc(np.asarray([k for k, _ in items], dtype=str),
                     "degree,",
                     np.asarray([v for _, v in items], dtype=np.float64))

    def ping(self) -> bool:
        return self._rpc("ping") == "pong"

    @property
    def n_entries(self) -> int:
        return int(self._rpc("n_entries"))

    def close(self) -> None:
        with self._pool_lock:
            self._closed = True
            pool, self._pool = self._pool, []
        for s in pool:
            self._discard(s)

    def __repr__(self) -> str:
        return f"ShardClient({self.name} at {self.address})"


# ---------------------------------------------------------------------------
# The backend: N shard clients behind the MultiInstanceDB fan-out.
# ---------------------------------------------------------------------------

class NetMultiInstanceDB(MultiInstanceDB):
    """M networked shards behind the same fan-out/merge machinery as the
    in-process topologies: ``instances`` are :class:`ShardClient`\\ s, so
    the inherited row-hash ``put_triples`` partitioning, streaming k-way
    scan merges, and degree aggregation all apply verbatim — and the
    WriterPool attaches one writer thread per shard.

    ``addresses`` connects to running :class:`ShardServer` processes.
    Without it, ``n_instances`` local in-process servers are started and
    owned by this backend (LSM-backed under ``path/db*`` when ``path``
    is given, volatile EdgeStores otherwise) — single-node mode, also
    what the tests and ``bench_net.py`` drive.  ``connect_timeout`` and
    ``io_timeout`` pass to every :class:`ShardClient`."""

    def __init__(self, addresses: Optional[Sequence[str]] = None,
                 n_instances: int = 2, path: Optional[str] = None,
                 tablets_per_instance: int = 4,
                 connect_timeout: float = 5.0,
                 io_timeout: Optional[float] = None,
                 chunk_items: int = DEFAULT_CHUNK_ITEMS, **engine_opts):
        self.servers: list[ShardServer] = []
        if addresses is None:
            for i in range(n_instances):
                if path is not None:
                    from .lsmstore import LSMStore
                    store = LSMStore(os.path.join(path, f"db{i}"),
                                     name=f"db{i}", **engine_opts)
                else:
                    store = EdgeStore(tablets_per_instance, name=f"db{i}",
                                      **engine_opts)
                self.servers.append(
                    ShardServer(store, chunk_items=chunk_items).start())
            addresses = [s.address for s in self.servers]
        elif engine_opts:
            raise ValueError(
                f"engine options {sorted(engine_opts)} apply to "
                f"auto-started local shards; remote servers own their "
                f"store configuration")
        self.instances = [
            ShardClient(addr, name=f"db{i}",
                        connect_timeout=connect_timeout,
                        io_timeout=io_timeout)
            for i, addr in enumerate(addresses)]

    @staticmethod
    def key_hash(k: str) -> int:
        """Stable routing hash — shard placement is server-side state
        shared by every producer process, so the process-salted default
        would scatter a key's updates across shards."""
        return zlib.crc32(k.encode())

    def sync(self) -> None:
        """The cross-shard durability commit point: fan out to every
        dirty shard (each fsyncs its WAL); ~µs when no client-side
        writes are outstanding."""
        for inst in self.instances:
            inst.sync()

    def close(self) -> None:
        for inst in self.instances:
            inst.close()
        for srv in self.servers:
            srv.stop(close_store=True)

    def __repr__(self) -> str:
        kind = "local" if self.servers else "remote"
        return (f"NetMultiInstanceDB({len(self.instances)} {kind} "
                f"shard(s): {[i.address for i in self.instances]})")


# ---------------------------------------------------------------------------
# Standalone shard server CLI.
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> None:
    """``python -m repro_torch.db.netstore --port 9101 --path /data/shard0``
    serves one shard until SIGTERM/SIGINT; prints ``LISTENING host:port``
    once bound (port 0 = ephemeral, for test harnesses)."""
    import argparse
    import signal

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--path", default=None,
                   help="LSM store directory (durable); omit for a "
                        "volatile in-memory shard")
    p.add_argument("--tablets", type=int, default=4,
                   help="tablets for a volatile shard (ignored with "
                        "--path)")
    p.add_argument("--memtable-limit", type=int, default=200_000)
    p.add_argument("--chunk-items", type=int, default=DEFAULT_CHUNK_ITEMS)
    args = p.parse_args(argv)

    if args.path is not None:
        from .lsmstore import LSMStore
        store = LSMStore(args.path, memtable_limit=args.memtable_limit)
    else:
        store = EdgeStore(args.tablets, name="shard")
    srv = ShardServer(store, host=args.host, port=args.port,
                      chunk_items=args.chunk_items).start()
    print(f"LISTENING {srv.address}", flush=True)

    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    srv.stop(close_store=True)


if __name__ == "__main__":
    main()
