"""Backend registry — named storage engines behind the ``DB()`` surface.

Every caller goes through one binding, and this registry names the
engine behind it: ``DB(..., backend="memory")`` and ``DB(...,
backend="lsm", path=...)`` bind the same query surface to the in-process
and the persistent store, and ``DB(..., backend="net",
addresses=[...])`` binds it to networked shard servers.
Anything implementing the :class:`~repro_torch.db.edgestore.EdgeStore` scan
protocol (``scan_keys`` / ``scan_key_range`` / ``scan_prefix`` /
``scan_everything`` / ``degree`` / ``degree_items`` / ``put_triples`` /
``put_degree``) can register here and immediately serves ``DBTable``
subscripts, ``LazyAssoc`` planning, the :class:`ScanCache`, and the
async :class:`~repro_torch.db.writer.WriterPool`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from .edgestore import EdgeStore, MultiInstanceDB
from .lsmstore import LSMMultiInstanceDB, LSMStore

BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str, factory: Callable) -> None:
    """Register a named backend factory.  The factory is called as
    ``factory(n_instances=..., tablets_per_instance=..., path=...,
    **options)`` and must return a store speaking the EdgeStore scan
    protocol (single instance or a ``.instances`` fan-out)."""
    BACKENDS[name] = factory


def make_backend(name: str, *, n_instances: int = 1,
                 tablets_per_instance: int = 4,
                 path: Optional[str] = None, **options):
    try:
        factory = BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {sorted(BACKENDS)}"
        ) from None
    return factory(n_instances=n_instances,
                   tablets_per_instance=tablets_per_instance,
                   path=path, **options)


def _memory(*, n_instances: int, tablets_per_instance: int,
            path: Optional[str] = None, **options):
    """The in-process engine: volatile, fast, no ``path``."""
    if path is not None:
        raise ValueError("backend='memory' takes no path= (it is volatile); "
                         "use backend='lsm' for a durable store")
    if n_instances == 1:
        return EdgeStore(n_tablets=tablets_per_instance, **options)
    return MultiInstanceDB(n_instances=n_instances,
                           tablets_per_instance=tablets_per_instance,
                           **options)


def _net(*, n_instances: int, tablets_per_instance: int,
         path: Optional[str] = None, **options):
    """The networked shard engine: ``addresses=["host:port", ...]``
    connects to running ``repro_torch.db.netstore`` shard servers;
    without it ``n_instances`` local servers are auto-started (LSM-backed
    under ``path`` when given).  See :mod:`repro_torch.db.netstore`."""
    from .netstore import NetMultiInstanceDB
    return NetMultiInstanceDB(n_instances=n_instances, path=path,
                              tablets_per_instance=tablets_per_instance,
                              **options)


def _lsm(*, n_instances: int, tablets_per_instance: int,
         path: Optional[str] = None, **options):
    """The persistent LSM engine: WAL + memtable + sorted runs under
    ``path`` (one subdirectory per instance when ``n_instances > 1``).
    ``tablets_per_instance`` is accepted for signature parity and
    ignored — an LSM instance's parallelism is its run set."""
    del tablets_per_instance
    if path is None:
        raise ValueError("backend='lsm' requires path= (the store's "
                         "directory)")
    if n_instances == 1:
        return LSMStore(path, **options)
    return LSMMultiInstanceDB(path, n_instances=n_instances, **options)


register_backend("memory", _memory)
register_backend("lsm", _lsm)
register_backend("net", _net)
