"""`ctypes` wrappers of the maze_route CUDA kernels (`csrc/maze_route.cu`).

`wavefront` replaces `repro.kernels.maze_route.kernel.wavefront_kernel`
(one CTA per grid, the field in shared memory when it fits);
`trace_paths` is the port's kernel for the jnp backtrace and occupancy
commit of `repro.eda.batched_flow._route_step`.  For tensors on the CPU
a wrapper runs the plain version (`ref.py`); for CUDA tensors it
launches the kernel, counts the launch in
`repro_torch.kernels.LAUNCHES`, and raises on a launch error.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.maze_route import ref

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("maze_route")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wavefront_smem_cells.argtypes = []
        lib.wavefront_smem_cells.restype = i
        lib.wavefront.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.wavefront.restype = i
        lib.trace_paths.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.trace_paths.restype = i
        _LIB = lib
    return _LIB


def _need(t: torch.Tensor, dtype, shape, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def wavefront(occ: torch.Tensor, seed: torch.Tensor,
              grids: torch.Tensor | None = None,
              max_cells: int | None = None) -> torch.Tensor:
    """occ, seed: (B, H, W) bool.  Returns (B, H, W) int32 BFS distances
    (seeds 0 even when occupied, `INF` unreachable or blocked).

    `grids` (B, 2) int32 gives each grid's own (gh, gw): the kernel
    relaxes only those cells and writes `INF` beyond them (cells there
    count as blocked).  `max_cells`, the largest gh*gw of the batch,
    sizes the shared memory; without it the whole plane is assumed."""
    b, h, w = occ.shape
    _need(occ, torch.bool, (b, h, w), "occ")
    _need(seed, torch.bool, (b, h, w), "seed")
    if grids is not None:
        _need(grids, torch.int32, (b, 2), "grids")
    if occ.device.type == "cpu":
        return ref.wavefront_distance_ref(occ, seed, grids)
    lib = _lib()
    cells = h * w if max_cells is None else max_cells
    smem_cells = cells if cells <= lib.wavefront_smem_cells() else 0
    dist = torch.empty((b, h, w), dtype=torch.int32, device=occ.device)
    rc = lib.wavefront(occ.data_ptr(), seed.data_ptr(),
                       None if grids is None else grids.data_ptr(),
                       dist.data_ptr(), b, h, w, smem_cells,
                       _build.stream_ptr(occ))
    _build.check(rc, "wavefront")
    LAUNCHES["wavefront"] += 1
    return dist


def trace_paths(dist, tgts, tmask, nmask, occ, routed, failed, wirelen):
    """Trace one net slot on every grid and commit it, in place.

    dist (B, H, W) int32; tgts (B, T, 2) int32 (gy, gx); tmask (B, T)
    bool; nmask (B,) bool; occ (B, H, W) int32 and routed / failed /
    wirelen (B,) int32 are updated.  Plain version:
    `ref.trace_paths_ref`."""
    b, h, w = dist.shape
    t = tgts.shape[1]
    _need(dist, torch.int32, (b, h, w), "dist")
    _need(tgts, torch.int32, (b, t, 2), "tgts")
    _need(tmask, torch.bool, (b, t), "tmask")
    _need(nmask, torch.bool, (b,), "nmask")
    _need(occ, torch.int32, (b, h, w), "occ")
    for name, x in (("routed", routed), ("failed", failed),
                    ("wirelen", wirelen)):
        _need(x, torch.int32, (b,), name)
    if dist.device.type == "cpu":
        ref.trace_paths_ref(dist, tgts, tmask, nmask, occ, routed, failed,
                            wirelen)
        return
    rc = _lib().trace_paths(
        dist.data_ptr(), tgts.data_ptr(), tmask.data_ptr(), nmask.data_ptr(),
        occ.data_ptr(), routed.data_ptr(), failed.data_ptr(),
        wirelen.data_ptr(), b, t, h, w, _build.stream_ptr(dist))
    _build.check(rc, "trace_paths")
    LAUNCHES["trace_paths"] += 1
