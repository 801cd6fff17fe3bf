"""repro_torch.db — the Accumulo-analog edge store and its D4M binding.

Query through :func:`DB` / :class:`DBTable` (tables as associative
arrays); storage engines live behind the backend registry:
``backend="memory"`` (:class:`EdgeStore` / :class:`MultiInstanceDB`),
``backend="lsm"`` (:class:`LSMStore` / :class:`LSMMultiInstanceDB`, the
durable WAL + sorted-runs store), or ``backend="net"``
(:class:`NetMultiInstanceDB` — networked shard servers, each owning an
LSM or memory store behind a framed TCP protocol).
"""
from .binding import (DB, DEFAULT_FULL_SCAN_WPS_LIMIT, DEFAULT_SCAN_TTL,
                      AccidentalDenseError, DBTable, ScanCache, TableStats,
                      bind, put)
from .edgestore import EdgeStore, MultiInstanceDB, Tablet
from .lsmstore import LSMMultiInstanceDB, LSMStore, SSTable
from .netstore import (NetMultiInstanceDB, ShardClient, ShardError,
                       ShardServer)
from .registry import BACKENDS, make_backend, register_backend
from .writer import AsyncWriterError, WriterPool

__all__ = ["DB", "DBTable", "put", "bind", "AccidentalDenseError",
           "EdgeStore", "MultiInstanceDB", "Tablet",
           "LSMStore", "LSMMultiInstanceDB", "SSTable",
           "NetMultiInstanceDB", "ShardServer", "ShardClient", "ShardError",
           "BACKENDS", "register_backend", "make_backend",
           "WriterPool", "AsyncWriterError", "ScanCache", "TableStats",
           "DEFAULT_SCAN_TTL", "DEFAULT_FULL_SCAN_WPS_LIMIT"]
