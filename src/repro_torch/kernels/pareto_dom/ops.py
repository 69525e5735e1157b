"""Public pareto_dom entry points: pad the population, call the kernel
wrapper, strip the padding.

Pad rows are +inf in every objective: they dominate nothing, so the
real block of the dominance matrix is unchanged, and every real point
dominates them, so they peel strictly after every real point and the
real prefix of the rank vector is the unpadded sort.
"""
from __future__ import annotations

import torch

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
