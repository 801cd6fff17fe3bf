"""Build the port's objects from host arrays, so two implementations that
hold the same state (a COO's triples, an ELL pack, an Assoc's key
dictionaries and scipy payload) can be made to compute on identical
inputs.  Arrays are taken as they are: no sort, no coalesce."""
from __future__ import annotations

import numpy as np
import torch

from .assoc import Assoc
from .sparse import COO, to_device


def coo_from_numpy(rows, cols, vals, shape) -> COO:
    """A :class:`COO` on the current device over the given triples."""
    return COO(to_device(rows, torch.int32), to_device(cols, torch.int32),
               to_device(vals), tuple(int(n) for n in shape))


def ell_from_numpy(ecols, evals) -> tuple[torch.Tensor, torch.Tensor]:
    """An ELL pack (int32 cols, float32 vals) on the current device."""
    return (to_device(np.ascontiguousarray(ecols), torch.int32),
            to_device(np.ascontiguousarray(evals), torch.float32))


def assoc_from_parts(row_keys, col_keys, scipy_payload) -> Assoc:
    """A numeric :class:`Assoc` over sorted key dictionaries and a scipy
    payload aligned with them (copied, canonical CSR)."""
    return Assoc._from_parts(np.asarray(row_keys), np.asarray(col_keys),
                             None, scipy_payload.tocsr(copy=True))
