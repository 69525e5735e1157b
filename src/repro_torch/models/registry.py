"""Model registry: the reference's uniform `ModelAPI` for the families
the port builds.

Counterpart of `repro.models.registry`.  `build_model(cfg)` gives the
dense LM's `init`, `init_decode_state` and `decode_step`; the training
loss, its parameter accounting and the other families are not ported
and raise, naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., Any]                      # (seed=0, device=, dtype=)
    init_decode_state: Callable[..., Any]         # (batch, max_seq, device=)
    decode_step: Callable[[Any, Any, Any], tuple[Any, Any]]


def build_model(cfg: ArchConfig) -> ModelAPI:
    """The dense LM's API; raises `NotImplementedError` for the families
    and variants that are not ported (`lm.check_dense`)."""
    lm.check_dense(cfg)
    return ModelAPI(
        cfg,
        init=lambda seed=0, **kw: lm.init_lm(cfg, seed=seed, **kw),
        init_decode_state=lambda bs, s, **kw: lm.init_decode_state(
            cfg, bs, s, **kw),
        decode_step=lambda p, st, t: lm.decode_step(p, st, t, cfg))
