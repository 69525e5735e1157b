"""Public maze_route entry points: shapes, padding, and the kernel call.

`wavefront_distance` accepts a single (H, W) grid or a (B, H, W) stack
and returns int32 BFS distances (`INF` = unreachable).  Four
implementations sit behind it, all giving the identical field (BFS
fields are unique):

  impl="kernel"    the `wavefront` CUDA kernel (`kernel.py`), CUDA
                   tensors only
  impl="ref"       the plain sweeping version (`ref.py`), any device
  impl="frontier"  the host numpy frontier-bucketed engine (`frontier.py`)
  impl="bfs"       the pure-Python deque BFS oracle (`oracle.py`)

`impl=None` takes the kernel for CUDA tensors and the plain sweep for
CPU tensors.  The host impls take CPU tensors or numpy arrays and
return numpy; given a tensor on another device they raise rather than
copy it to the host unasked.  The reference's deprecated `use_kernel=`
spelling is not carried over.

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

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.maze_route import kernel
from repro_torch.kernels.maze_route.frontier import \
    wavefront_distance_frontier
from repro_torch.kernels.maze_route.oracle import wavefront_distance_bfs
from repro_torch.kernels.maze_route.ref import (INF, outside_grids,
                                                wavefront_distance_ref)

__all__ = ["HOST_IMPLS", "IMPLS", "INF", "pad_blocked", "route_slots",
           "wavefront_distance"]

IMPLS = ("kernel", "ref", "frontier", "bfs")
HOST_IMPLS = ("frontier", "bfs")     # numpy in / numpy out


def pad_blocked(occ: torch.Tensor, seed: torch.Tensor, h: int, w: int):
    """Pad (B, H, W) occ / seed to (B, h, w): occ True, seed False."""
    _, h0, w0 = occ.shape
    pad = (0, w - w0, 0, h - h0)
    occ_p = F.pad(occ.to(torch.uint8), pad, value=1).to(torch.bool)
    seed_p = F.pad(seed.to(torch.uint8), pad, value=0).to(torch.bool)
    return occ_p, seed_p


def _host(x, name: str, impl: str) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"impl={impl!r} is a host engine; {name} is on "
                             f"{x.device} (pass a CPU tensor or numpy array)")
        x = x.numpy()
    return np.asarray(x, bool)


def wavefront_distance(occ, seed, grids=None, *, impl: str | None = None):
    """BFS distance field(s) for the Lee maze router.

    occ, seed: (H, W) or (B, H, W) bool.  `grids` (B, 2) int32, each
    grid's own extent within a padded batch (cells beyond it count as
    blocked and hold no seed), lets the kernel skip the pad.  Returns
    int32 distances of the same shape, a tensor for "kernel" / "ref"
    (on the inputs' device) and numpy for the host impls."""
    if impl is None:
        impl = ("kernel" if isinstance(occ, torch.Tensor)
                and occ.device.type == "cuda" else "ref")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl in HOST_IMPLS:
        occ_np, seed_np = _host(occ, "occ", impl), _host(seed, "seed", impl)
        if grids is not None:
            # lint: disable=host-guard,host-sync -- CPU inputs only (_host)
            out = outside_grids(occ_np.shape, torch.as_tensor(grids),
                                "cpu").numpy()
            occ_np, seed_np = occ_np | out, seed_np & ~out
        engine = (wavefront_distance_frontier if impl == "frontier"
                  else wavefront_distance_bfs)
        return engine(occ_np, seed_np)
    occ, seed = torch.as_tensor(occ), torch.as_tensor(seed)
    if impl == "kernel" and occ.device.type != "cuda":
        raise ValueError(f"impl='kernel' runs on CUDA tensors; occ is on "
                         f"{occ.device}")
    if grids is not None:
        grids = torch.as_tensor(grids, dtype=torch.int32,
                                device=occ.device).contiguous()
    squeeze = occ.dim() == 2
    if squeeze:
        occ, seed = occ[None], seed[None]
    occ = occ.to(torch.bool).contiguous()
    seed = seed.to(torch.bool).contiguous()
    if impl == "kernel":
        out = kernel.wavefront(occ, seed, grids)
    else:
        # lint: disable=host-guard -- impl='ref' asks for the plain sweep
        out = wavefront_distance_ref(occ, seed, grids)
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
