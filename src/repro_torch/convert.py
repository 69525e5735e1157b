"""Carry the reference's state into the port.

The design flow has no weights: its state is the calibration and the
request.  The LM substrate has weights (the reference's `init_lm`
pytree) and an architecture config.  These functions take the JAX
package's values in plain form (numpy arrays, dicts) so the two
packages can compute on the same operands; they import nothing of the
JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.request import DesignRequest
from repro_torch.configs import base as configs
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


_SUB_CONFIGS = {"moe": configs.MoEConfig, "mla": configs.MLAConfig,
                "ssm": configs.SSMConfig, "xlstm": configs.XLSTMConfig,
                "hybrid": configs.HybridConfig, "encdec": configs.EncDecConfig,
                "vlm": configs.VLMConfig}


def arch_config_from_dict(d: dict) -> configs.ArchConfig:
    """`dataclasses.asdict` of the reference's `ArchConfig` -> the port's."""
    d = dict(d)
    for k, cls in _SUB_CONFIGS.items():
        if d.get(k) is not None:
            d[k] = cls(**d[k])
    return configs.ArchConfig(**d)


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lm_params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """The reference's `init_lm` pytree with numpy leaves -> a state dict
    of `repro_torch.models.lm.LM` (`load_state_dict`).

    `blocks` holds every layer's leaves stacked on a leading n_layers
    axis; layer i's slice becomes `blocks.<i>.<path>`.  Nested dicts
    become dotted names; the leaves keep their dtype (float32)."""
    state = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k != "blocks"}):
        state[name] = _tensor(leaf)
    for path, leaf in _flatten(tree["blocks"]):
        for i in range(leaf.shape[0]):
            state[f"blocks.{i}.{path}"] = _tensor(leaf[i])
    return state
