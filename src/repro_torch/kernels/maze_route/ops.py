"""Public maze_route entry points: shapes, padding, and the kernel call.

`wavefront_distance` accepts a single (H, W) grid or a (B, H, W) stack
and returns int32 BFS distances (`INF` = unreachable): the CUDA kernel
for CUDA tensors, the plain sweeping version for CPU tensors.  Both
give the identical field (BFS fields are unique).

`route_slots` routes every net slot of a layout bucket: one
`route_slots` launch for CUDA tensors, `ref.route_slots_ref` for CPU
tensors.

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

__all__ = ["INF", "pad_blocked", "route_slots", "wavefront_distance"]


def pad_blocked(occ: torch.Tensor, seed: torch.Tensor, h: int, w: int):
    """Pad (B, H, W) occ / seed to (B, h, w): occ True, seed False."""
    _, h0, w0 = occ.shape
    pad = (0, w - w0, 0, h - h0)
    occ_p = F.pad(occ.to(torch.uint8), pad, value=1).to(torch.bool)
    seed_p = F.pad(seed.to(torch.uint8), pad, value=0).to(torch.bool)
    return occ_p, seed_p


def wavefront_distance(occ: torch.Tensor, seed: torch.Tensor,
                       grids: torch.Tensor | None = None) -> torch.Tensor:
    """BFS distance field(s) for the Lee maze router.

    occ, seed: (H, W) or (B, H, W) bool.  `grids` (B, 2) int32, each
    grid's own extent within a padded batch (cells beyond it count as
    blocked), lets the kernel skip the pad."""
    squeeze = occ.dim() == 2
    if squeeze:
        occ, seed = occ[None], seed[None]
    out = kernel.wavefront(occ.to(torch.bool).contiguous(),
                           seed.to(torch.bool).contiguous(), grids)
    return out[0] if squeeze else out


def route_slots(occ0, hubs, tgts, tmask, nmask, grids, capacity: int):
    """Route every net slot of a layout bucket in order (the reference's
    `_route_program`): occ0 (B, H, W) occupancy counts, the net slots
    hubs (B, S, 2), tgts (B, S, T, 2), tmask (B, S, T), nmask (B, S), and
    grids (B, 2) each grid's own extent.  Returns (occ, routed, failed,
    wirelen); see `kernel.route_slots`."""
    i32 = torch.int32
    return kernel.route_slots(
        occ0.to(i32).contiguous(), hubs.to(i32).contiguous(),
        tgts.to(i32).contiguous(), tmask.to(torch.bool).contiguous(),
        nmask.to(torch.bool).contiguous(), grids.to(i32).contiguous(),
        capacity)
