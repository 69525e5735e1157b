"""Carry the reference's state into the port.

The system has no weights: its state is the calibration and the
request.  These two functions take the JAX package's values in plain
form (numpy arrays, dicts) so the two packages can compute on the same
operands; they import nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.request import DesignRequest
from repro_torch.core.estimator import CalOperands
from repro_torch.core.nsga2 import SpaceOperands


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def space_operands_from_numpy(d: dict):
    """The reference's `SpaceOperands` or `CalOperands` leaves as numpy
    arrays -> the port's tensors.

    `d` maps the reference's field names to arrays: the 14
    `CalOperands` fields give a `CalOperands`; `array_size`, `gene_lo`,
    `gene_hi` and `cal` (a dict of the 14) give a `SpaceOperands`.
    Leaves keep their shape, so a batch stacked by the reference stays
    a batch (one leading cell dimension)."""
    if "cal" in d:
        return SpaceOperands(
            array_size=_tensor(d["array_size"]).to(torch.float32),
            gene_lo=_tensor(d["gene_lo"]).to(torch.int32),
            gene_hi=_tensor(d["gene_hi"]).to(torch.int32),
            cal=space_operands_from_numpy(d["cal"]))
    return CalOperands(**{k: _tensor(d[k]).to(torch.float32)
                          for k in CalOperands._fields})


def request_from_dict(d: dict) -> DesignRequest:
    """The reference's `DesignRequest.to_dict()` -> the port's request."""
    return DesignRequest.from_dict(d)
