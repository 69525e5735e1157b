"""Model registry: the reference's uniform `ModelAPI` over every family,
plus the parameter accounting of the roofline terms.

Counterpart of `repro.models.registry`.  `build_model(cfg)` gives the
`init`, `loss`, `init_decode_state` and `decode_step` of the LM
(`models.lm`: the dense, MoE, hybrid and SSM families), of the VLM
(`models.paligemma`: the loss over a batch with patches) and of the
encoder-decoder (`models.whisper`: the audio family, a batch with
frames); a config none of them builds raises `ValueError`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm, paligemma, whisper


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., Any]                      # (seed=0, device=, dtype=)
    loss: Callable[[Any, dict], tuple[Any, dict]]  # (params, batch)
    init_decode_state: Callable[..., Any]         # (batch, max_seq, device=)
    decode_step: Callable[[Any, Any, Any], tuple[Any, Any]]


def build_model(cfg: ArchConfig, *, remat: bool = False,
                mlstm_chunked: bool = False) -> ModelAPI:
    """The model's API: whisper's for the audio family; the VLM's
    decoder with its prefix loss; else the LM's (dense or MoE, GQA or
    MLA; the hybrid family's Mamba2 groups with their shared block; the
    SSM family's (mLSTM, sLSTM) pairs, whose loss runs the mLSTM
    chunkwise when `mlstm_chunked`).  `remat` checkpoints each block in
    the loss.  Raises `ValueError` for a config none of them builds
    (`lm.check_dense`, `whisper.check_audio`)."""
    if cfg.family == "audio":
        whisper.check_audio(cfg)
        return ModelAPI(
            cfg,
            init=lambda seed=0, **kw: whisper.init_whisper(cfg, seed=seed,
                                                           **kw),
            loss=lambda p, b: whisper.whisper_loss(p, b, cfg, remat=remat),
            init_decode_state=lambda bs, s, **kw:
                whisper.init_whisper_decode_state(cfg, bs, s, **kw),
            decode_step=lambda p, st, t: whisper.whisper_decode_step(
                p, st, t, cfg))
    lm.check_dense(cfg)
    if cfg.family == "vlm":
        return ModelAPI(
            cfg,
            init=lambda seed=0, **kw: paligemma.init_paligemma(
                cfg, seed=seed, **kw),
            loss=lambda p, b: paligemma.paligemma_loss(p, b, cfg,
                                                       remat=remat),
            init_decode_state=lambda bs, s, **kw: paligemma.init_decode_state(
                cfg, bs, s, **kw),
            decode_step=lambda p, st, t: paligemma.decode_step(p, st, t, cfg))
    return ModelAPI(
        cfg,
        init=lambda seed=0, **kw: lm.init_lm(cfg, seed=seed, **kw),
        loss=lambda p, b: lm.lm_loss(p, b, cfg, remat=remat,
                                     mlstm_chunked=mlstm_chunked),
        init_decode_state=lambda bs, s, **kw: lm.init_decode_state(
            cfg, bs, s, **kw),
        decode_step=lambda p, st, t: lm.decode_step(p, st, t, cfg))


def meta_model(cfg: ArchConfig,
               dtype: torch.dtype | None = None) -> torch.nn.Module:
    """`cfg`'s model (`build_model(cfg).init`, the serving cast to `dtype`
    where one is given) with every parameter on the `meta` device:
    shapes and dtypes, nothing allocated or drawn."""
    with torch.device("meta"):
        return build_model(cfg).init(device="meta", dtype=dtype)


# ---------------------------------------------------------------------------
# parameter accounting (for 6*N*D roofline terms)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact count from the parameters' shapes: the model is built on the
    `meta` device (`meta_model`), so nothing is allocated or drawn (and
    the count is kept per config: arctic's meta model takes seconds).
    `active_only`
    counts the routed experts' `wi` / `wg` / `wo` at top_k of E (the
    shared experts and the dense residual FFN in full), the reference's
    6 N_active D convention: its rule picks the expert leaves by their
    stacked rank, >= 3.  The hybrid family's shared block counts once,
    as the reference's one `shared` subtree."""
    total = 0
    for name, p in meta_model(cfg).named_parameters():
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
