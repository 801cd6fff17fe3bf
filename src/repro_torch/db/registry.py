"""Backend registry — named storage engines behind the ``DB()`` surface.

Every caller goes through one binding, and this registry names the
engine behind it: ``DB(..., backend="memory")`` binds the query surface
to the in-process store.  ``"lsm"`` and ``"net"`` are registered so the
names stay reserved, and raise ``NotImplementedError`` until those
engines are ported.
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
        raise ValueError("backend='memory' takes no path= (it is volatile)")
    if n_instances == 1:
        return EdgeStore(n_tablets=tablets_per_instance, **options)
    return MultiInstanceDB(n_instances=n_instances,
                           tablets_per_instance=tablets_per_instance,
                           **options)


def _not_ported(name: str) -> Callable:
    def factory(**options):
        raise NotImplementedError(
            f"backend={name!r} is not ported to repro_torch yet; it is "
            f"queued as the next db slice (the lsm, then the net backend). "
            f"Use backend='memory'.")
    return factory


register_backend("memory", _memory)
register_backend("lsm", _not_ported("lsm"))
register_backend("net", _not_ported("net"))
