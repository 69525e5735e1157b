"""Dense FFN (gated or plain, optional bias).

Counterpart of the dense part of `repro.models.mlp` (MoE is not ported).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import act_fn, dense_init


class MLP(nn.Module):
    """`wi` (D, F), `wo` (F, D); `wg` (D, F) when gated; `bi`, `bo`
    with `mlp_bias`."""

    def __init__(self, d: int, ff: int, cfg: ArchConfig,
                 generator: torch.Generator):
        super().__init__()
        self.wi = nn.Parameter(dense_init(generator, (d, ff)))
        self.wo = nn.Parameter(dense_init(generator, (ff, d)))
        if cfg.mlp_gated:
            self.wg = nn.Parameter(dense_init(generator, (d, ff)))
        if cfg.mlp_bias:
            self.bi = nn.Parameter(torch.zeros(ff))
            self.bo = nn.Parameter(torch.zeros(d))


def init_mlp(d: int, ff: int, cfg: ArchConfig,
             generator: torch.Generator) -> MLP:
    return MLP(d, ff, cfg, generator)


def mlp_fwd(p: MLP, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    act = act_fn(cfg.act)
    h = x @ p.wi.to(x.dtype)
    if cfg.mlp_bias:
        h = h + p.bi.to(x.dtype)
    if cfg.mlp_gated:
        h = act(x @ p.wg.to(x.dtype)) * h
    else:
        h = act(h)
    y = h @ p.wo.to(x.dtype)
    if cfg.mlp_bias:
        y = y + p.bo.to(x.dtype)
    return y
