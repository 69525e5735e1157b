"""Public pareto_dom entry points: pad the population, call the kernel
wrapper, strip the padding.

Pad rows are +inf in every objective: they dominate nothing, so the
real block of the dominance matrix is unchanged, and every real point
dominates them, so they peel strictly after every real point and the
real prefix of the rank vector is the unpadded sort.
"""
from __future__ import annotations

import torch

from repro_torch.core import pareto
from repro_torch.kernels.pareto_dom import kernel

RANK_MULTIPLE = 32     # nds_rank packs 32 dominators per word


def _pad_inf(f: torch.Tensor, multiple: int) -> torch.Tensor:
    *batch, p, m = f.shape
    pad = (-p) % multiple
    if pad:
        f = torch.cat([f, torch.full((*batch, pad, m), float("inf"),
                                     dtype=f.dtype, device=f.device)], -2)
    return f


def dominance_matrix(f: torch.Tensor) -> torch.Tensor:
    """f: (C, P, M) objectives.  Returns (C, P, P) bool."""
    return kernel.dominance_matrix(f.to(torch.float32).contiguous())


def non_dominated_rank(f: torch.Tensor) -> torch.Tensor:
    """Fused non-dominated sort: (C, P, M) -> (C, P) int32 ranks.
    Plain version: `repro_torch.core.pareto.non_dominated_rank`."""
    p = f.shape[-2]
    fp = _pad_inf(f.to(torch.float32), RANK_MULTIPLE).contiguous()
    return kernel.nds_rank(fp)[..., :p]


def rank_and_crowd(f: torch.Tensor):
    """Fused rank-and-crowd path: (ranks, crowding) of (P, M) or (C, P, M)
    objectives, the ranks from the `nds_rank` kernel (on CUDA) and the
    crowding distance from `pareto.crowding_distance`.  The reference's
    `rank_and_crowd` (the NSGA-II step's `use_pallas_rank` route)."""
    batched = f.dim() == 3
    fb = f if batched else f[None]
    ranks = non_dominated_rank(fb)
    crowd = pareto.crowding_distance(fb.to(torch.float32), ranks)
    return (ranks, crowd) if batched else (ranks[0], crowd[0])


def nsga2_evolve(draws, genes: torch.Tensor, objs: torch.Tensor, space,
                 statics, fronts: torch.Tensor | None = None):
    """Every generation of an explore dispatch: (C, P, 3) genes and (C, P,
    4) objectives of the initial populations and stacked draws (leading
    G) -> the final (genes, objs, ranks).  Plain version:
    `nsga2.evolve_composite` (`ref.nsga2_evolve_ref`)."""
    return kernel.nsga2_evolve(draws, genes.to(torch.int32).contiguous(),
                               objs.to(torch.float32).contiguous(), space,
                               statics, fronts=fronts)
