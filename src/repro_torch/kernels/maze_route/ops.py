"""Public maze_route entry points: shapes, padding, and the kernel call.

`wavefront_distance` accepts a single (H, W) grid or a (B, H, W) stack
and returns int32 BFS distances (`INF` = unreachable): the CUDA kernel
for CUDA tensors, the plain sweeping version for CPU tensors.  Both
give the identical field (BFS fields are unique).

`pad_blocked` pads grids to a larger extent with *blocked* cells and no
seeds.  Blocked padding is the correctness argument: a free pad region
would let wavefronts leave a grid at its edge and re-enter elsewhere.
The batched router relies on it when it stacks grids of different
sizes into one batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.maze_route import kernel
from repro_torch.kernels.maze_route.ref import INF

__all__ = ["INF", "pad_blocked", "wavefront_distance"]


def pad_blocked(occ: torch.Tensor, seed: torch.Tensor, h: int, w: int):
    """Pad (B, H, W) occ / seed to (B, h, w): occ True, seed False."""
    _, h0, w0 = occ.shape
    pad = (0, w - w0, 0, h - h0)
    occ_p = F.pad(occ.to(torch.uint8), pad, value=1).to(torch.bool)
    seed_p = F.pad(seed.to(torch.uint8), pad, value=0).to(torch.bool)
    return occ_p, seed_p


def wavefront_distance(occ: torch.Tensor, seed: torch.Tensor,
                       grids: torch.Tensor | None = None,
                       max_cells: int | None = None) -> torch.Tensor:
    """BFS distance field(s) for the Lee maze router.

    occ, seed: (H, W) or (B, H, W) bool.  `grids` (B, 2) int32, each
    grid's own extent within a padded batch (cells beyond it must be
    blocked), lets the kernel skip the pad; `max_cells` is the largest
    gh*gw (see `kernel.wavefront`)."""
    squeeze = occ.dim() == 2
    if squeeze:
        occ, seed = occ[None], seed[None]
    out = kernel.wavefront(occ.to(torch.bool).contiguous(),
                           seed.to(torch.bool).contiguous(), grids, max_cells)
    return out[0] if squeeze else out
