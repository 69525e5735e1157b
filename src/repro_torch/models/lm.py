"""Dense decoder-only LM assembled from an ArchConfig.

Counterpart of the dense family of `repro.models.lm`: `init_lm` builds
the parameters as `nn.Module`s whose state-dict names follow the
reference's pytree (`emb`, `blocks.<i>.ln1.scale`, `blocks.<i>.attn.wq`,
..., `final_norm.scale`, `head`), with the reference's stacked
`blocks` axis unrolled into a `ModuleList`.  The forward that runs on
these parameters is the trainer's (`repro_torch.train.acim_lm`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp
from repro_torch.models.common import dense_init, embed_init, init_norm


class Block(nn.Module):
    """One attention + FFN layer (the reference's `_init_block`): `ln1`,
    `attn`, `ln2`, `ffn`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.ln1 = init_norm(d, cfg.norm)
        self.attn = attn.init_attention(cfg, generator)
        self.ln2 = init_norm(d, cfg.norm)
        self.ffn = mlp.init_mlp(d, cfg.d_ff, cfg, generator)


class LM(nn.Module):
    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        if cfg.family != "dense" or cfg.mla is not None or cfg.moe is not None:
            raise NotImplementedError(
                f"the port builds the dense family only, not {cfg.family!r}")
        if cfg.pos == "learned":
            raise NotImplementedError("learned positions are not ported")
        self.emb = nn.Parameter(embed_init(generator, (cfg.vocab, cfg.d_model)))
        self.blocks = nn.ModuleList(Block(cfg, generator)
                                    for _ in range(cfg.n_layers))
        self.final_norm = init_norm(cfg.d_model, cfg.norm)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(dense_init(generator,
                                                (cfg.d_model, cfg.vocab)))


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None) -> LM:
    """Parameters from a CPU `torch.Generator` seeded with `seed`, moved
    to `device` (CUDA when None, raising without it): one seed gives the
    same weights on every device."""
    g = torch.Generator().manual_seed(seed)
    return LM(cfg, g).to(resolve_device(device))


def lm_logits(params: LM, hidden: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    head = params.emb.t() if cfg.tie_embeddings else params.head
    return hidden @ head.to(hidden.dtype)
