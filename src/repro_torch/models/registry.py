"""Model registry: the reference's uniform `ModelAPI` for the families
the port builds, plus the parameter accounting of the roofline terms.

Counterpart of `repro.models.registry`.  `build_model(cfg)` gives the
LM's `init`, `loss`, `init_decode_state` and `decode_step` for the
dense and MoE families; the other families are not ported and raise,
naming the ROADMAP item that brings them.
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
    """The LM's API (dense or MoE, GQA or MLA); raises
    `NotImplementedError` for the families and variants that are not
    ported (`lm.check_dense`)."""
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
    counts the routed experts' `wi` / `wg` / `wo` at top_k of E (the
    shared experts and the dense residual FFN in full), the reference's
    6 N_active D convention: its rule picks the expert leaves by their
    stacked rank, >= 3."""
    with torch.device("meta"):
        model = lm.LM(cfg, torch.Generator(), device="meta")
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        parts = name.split(".")
        if (active_only and cfg.moe is not None and "ffn" in parts
                and parts[-1] in ("wi", "wg", "wo")
                and "shared" not in parts and "dense" not in parts
                and lm.stacked_ndim(name, p) >= 3):
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n
    return total


def embedding_params(cfg: ArchConfig) -> int:
    n = cfg.vocab * cfg.d_model
    if not cfg.tie_embeddings and cfg.family != "audio":
        n *= 2
    if cfg.pos == "learned":
        n += 8192 * cfg.d_model
    return n
