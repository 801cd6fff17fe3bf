"""JSON-serializable report paths for the analytics outputs.

The detectors return NamedTuples holding numpy arrays and torch tensor
scalars (possibly on the card) — ``json.dumps`` raises ``TypeError`` on every one of them.  The
serving gateway (and anything else shipping reports over a wire) needs
plain Python containers, so each report type gains ``to_dict`` /
``to_json`` built on :func:`to_jsonable`, plus a ``from_dict`` that
rebuilds the NamedTuple (arrays come back as numpy) for round-trips.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch


def to_jsonable(obj: Any) -> Any:
    """Recursively coerce numpy / torch values to plain Python: scalars to
    ``int``/``float``/``bool``/``str``, arrays to (nested) lists, and
    mappings/sequences element-wise.  Anything already JSON-native passes
    through untouched."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.generic,)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return [to_jsonable(x) for x in obj.tolist()] \
            if obj.dtype == object else obj.tolist()
    if isinstance(obj, torch.Tensor):      # a card tensor copies to host
        return to_jsonable(obj.detach().cpu().numpy())
    # anything else array-like with .item/.tolist
    if hasattr(obj, "tolist") and hasattr(obj, "shape"):
        return to_jsonable(np.asarray(obj))
    if isinstance(obj, dict):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [to_jsonable(x) for x in obj]
    raise TypeError(f"cannot coerce {type(obj).__name__} to JSON")


class JsonReportMixin:
    """``to_dict``/``to_json``/``from_dict`` for report NamedTuples.

    Mix into a class defined with the NamedTuple *class* syntax::

        class C2Report(NamedTuple, JsonReportMixin): ...   # not allowed

    NamedTuple forbids extra bases, so instead the report classes define
    the three methods by assignment (``to_dict = JsonReportMixin.to_dict``)
    — same behavior, satisfies NamedTuple's single-base restriction.
    """

    def to_dict(self) -> dict:
        return {k: to_jsonable(v) for k, v in self._asdict().items()}

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_dict(cls, d: dict):
        """Rebuild from :meth:`to_dict` output; list-valued fields come
        back as numpy arrays (string keys stay ``dtype=str``)."""
        vals = []
        for name in cls._fields:
            v = d[name]
            vals.append(np.asarray(v) if isinstance(v, list) else v)
        return cls(*vals)
