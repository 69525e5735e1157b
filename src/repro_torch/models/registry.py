"""Model registry: the reference's uniform `ModelAPI` for the families
the port builds, plus the parameter accounting of the roofline terms.

Counterpart of `repro.models.registry`.  `build_model(cfg)` gives the
dense LM's `init`, `loss`, `init_decode_state` and `decode_step`; the
other families are not ported and raise, naming the ROADMAP item that
brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., Any]                      # (seed=0, device=, dtype=)
    loss: Callable[[Any, dict], tuple[Any, dict]]  # (params, batch)
    init_decode_state: Callable[..., Any]         # (batch, max_seq, device=)
    decode_step: Callable[[Any, Any, Any], tuple[Any, Any]]


def build_model(cfg: ArchConfig, *, remat: bool = False) -> ModelAPI:
    """The dense LM's API; raises `NotImplementedError` for the families
    and variants that are not ported (`lm.check_dense`)."""
    lm.check_dense(cfg)
    return ModelAPI(
        cfg,
        init=lambda seed=0, **kw: lm.init_lm(cfg, seed=seed, **kw),
        loss=lambda p, b: lm.lm_loss(p, b, cfg, remat=remat),
        init_decode_state=lambda bs, s, **kw: lm.init_decode_state(
            cfg, bs, s, **kw),
        decode_step=lambda p, st, t: lm.decode_step(p, st, t, cfg))


# ---------------------------------------------------------------------------
# parameter accounting (for 6*N*D roofline terms)
# ---------------------------------------------------------------------------
def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact count from the parameters' shapes: the `LM` is built on the
    `meta` device, so nothing is allocated or drawn.  `active_only`
    counts MoE experts at top_k in the reference; the dense family the
    port builds has none, so both counts agree."""
    with torch.device("meta"):
        model = lm.LM(cfg, torch.Generator(), device="meta")
    return sum(p.numel() for p in model.parameters())


def embedding_params(cfg: ArchConfig) -> int:
    n = cfg.vocab * cfg.d_model
    if not cfg.tie_embeddings and cfg.family != "audio":
        n *= 2
    if cfg.pos == "learned":
        n += 8192 * cfg.d_model
    return n
