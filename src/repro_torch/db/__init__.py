"""repro_torch.db — the Accumulo-analog edge store and its D4M binding.

Query through :func:`DB` / :class:`DBTable` (tables as associative
arrays); storage engines live behind the backend registry.  The port
has the in-process engine, ``backend="memory"`` (:class:`EdgeStore` /
:class:`MultiInstanceDB`); ``"lsm"`` and ``"net"`` raise
``NotImplementedError`` until they are ported.
"""
from .binding import (DB, DEFAULT_FULL_SCAN_WPS_LIMIT, DEFAULT_SCAN_TTL,
                      AccidentalDenseError, DBTable, ScanCache, TableStats,
                      bind, put)
from .edgestore import EdgeStore, MultiInstanceDB, Tablet
from .registry import BACKENDS, make_backend, register_backend
from .writer import AsyncWriterError, WriterPool

__all__ = ["DB", "DBTable", "put", "bind", "AccidentalDenseError",
           "EdgeStore", "MultiInstanceDB", "Tablet",
           "BACKENDS", "register_backend", "make_backend",
           "WriterPool", "AsyncWriterError", "ScanCache", "TableStats",
           "DEFAULT_SCAN_TTL", "DEFAULT_FULL_SCAN_WPS_LIMIT"]
