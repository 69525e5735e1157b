"""`ctypes` wrappers of the maze_route CUDA kernels (`csrc/maze_route.cu`).

`route_slots` replaces the reference's `_route_program`
(`repro.kernels.maze_route.kernel.wavefront_kernel` plus the jnp
backtrace and commit of `repro.eda.batched_flow._route_step`, every net
slot under one `lax.scan`): one persistent launch per layout bucket.
`wavefront` is the standalone counterpart of `wavefront_kernel` (the
full BFS field) and `trace_paths` traces and commits one net slot over a
given field; both run the same device code as `route_slots`.  For
tensors on the CPU a wrapper runs the plain version (`ref.py`); for CUDA
tensors it launches the kernel, counts the launch in
`repro_torch.kernels.LAUNCHES`, and raises on a launch error.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.maze_route import ref

# One warp lane per star target; a walk packs a cell as (y << 16) | x.
MAX_TARGETS = 32
_MAX_H, _MAX_W = 2 ** 15, 2 ** 16
# route_slots' occupancy counts reach at most 2 A + 1, A the most masked
# targets of real slots a grid has (a walk enters a cell once): uint16 up
# to this, else uint32, all in the device-memory scratch.
_COUNT_MAX = 2 ** 16 - 1
# Bitsets per grid in `route_slots`: free, visited, two frontiers, the
# cells whose arrival resolves a target and two backtrace-direction
# planes, a 4-byte word per 32 cells of a row; its uint16 counts take 2
# bytes a cell.  Each sits in shared memory when it fits, else in a
# device-memory scratch (`wavefront` sizes its own: its library's
# `wavefront_scratch_bytes`).
_ROUTE_BITSETS, _ROUTE_CELL_BYTES = 7, 2
# The kernels split a word index into (row, word) by a float reciprocal,
# exact below 2^22 words per grid.
_MAX_WORDS = 2 ** 22

_LIB = None
_LIB_LOCK = threading.Lock()   # first calls may race from several threads


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = _build.load("maze_route")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.maze_route_smem_limit.argtypes = []
        lib.maze_route_smem_limit.restype = i
        lib.wavefront_scratch_bytes.argtypes = [i, i, i, i]
        lib.wavefront_scratch_bytes.restype = ctypes.c_longlong
        lib.wavefront.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.wavefront.restype = i
        lib.trace_paths.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.trace_paths.restype = i
        lib.route_slots.argtypes = ([p] * 13 + [i] * 10
                                    + [ctypes.c_longlong] * 2 + [p])
        lib.route_slots.restype = i
        _LIB = lib
        return _LIB


def _need(t: torch.Tensor, dtype, shape, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _same_device(**tensors) -> torch.device:
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    return devs.pop()


def _words(h: int, w: int) -> int:
    """Bitset words of an h x w grid: ceil(w / 32) per row."""
    return h * ((w + 31) // 32)


def wavefront(occ: torch.Tensor, seed: torch.Tensor,
              grids: torch.Tensor | None = None) -> torch.Tensor:
    """occ, seed: (B, H, W) bool.  Returns (B, H, W) int32 BFS distances
    (seeds 0 even when occupied, `INF` unreachable or blocked).

    `grids` (B, 2) int32 gives each grid's own (gh, gw): the kernel
    expands only those cells and writes `INF` beyond them (cells there
    count as blocked).  On the card the wrapper reads them back to size
    the launch by the largest grid."""
    b, h, w = occ.shape
    _need(occ, torch.bool, (b, h, w), "occ")
    _need(seed, torch.bool, (b, h, w), "seed")
    named = dict(occ=occ, seed=seed)
    if grids is not None:
        _need(grids, torch.int32, (b, 2), "grids")
        named["grids"] = grids
    if _same_device(**named).type == "cpu":
        return ref.wavefront_distance_ref(occ, seed, grids)
    words = _words(h, w)
    if words >= _MAX_WORDS:
        raise ValueError(f"wavefront: a {h} x {w} plane has {words} bitset "
                         f"words; the kernel takes fewer than {_MAX_WORDS}")
    # The largest grid's bitset words and cells pick the kernel, its shared
    # memory and its scratch: each grid's own extent, read back from the
    # card, or the plane's.
    if grids is None or b == 0:
        max_words, max_cells = words, h * w
    else:
        # lint: disable=host-sync -- the largest grid's extent sizes the launch
        g = np.minimum(grids.cpu().numpy().astype(np.int64), [h, w])
        g = np.maximum(g, 0)
        max_words = int((g[:, 0] * ((g[:, 1] + 31) // 32)).max())
        max_cells = int((g[:, 0] * g[:, 1]).max())
    lib = _lib()
    scratch = lib.wavefront_scratch_bytes(h, w, max_words, max_cells)
    g_bits = torch.empty(b * scratch // 4, dtype=torch.int32,
                         device=occ.device) if scratch else None
    dist = torch.empty((b, h, w), dtype=torch.int32, device=occ.device)
    _build.launch(occ, lib.wavefront, "wavefront", occ.data_ptr(),
                  seed.data_ptr(), None if grids is None else grids.data_ptr(),
                  dist.data_ptr(),
                  None if g_bits is None else g_bits.data_ptr(), b, h, w,
                  max_words, max_cells)
    count_launch("wavefront")
    return dist


def trace_paths(dist, tgts, tmask, nmask, occ, routed, failed, wirelen):
    """Trace one net slot on every grid and commit it, in place.

    dist (B, H, W) int32; tgts (B, T, 2) int32 (gy, gx), T <= 32; tmask
    (B, T) bool; nmask (B,) bool; occ (B, H, W) int32 and routed /
    failed / wirelen (B,) int32 are updated.  Plain version:
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
    dev = _same_device(dist=dist, tgts=tgts, tmask=tmask, nmask=nmask,
                       occ=occ, routed=routed, failed=failed,
                       wirelen=wirelen)
    if dev.type == "cpu":
        ref.trace_paths_ref(dist, tgts, tmask, nmask, occ, routed, failed,
                            wirelen)
        return
    if t > MAX_TARGETS or h >= _MAX_H or w >= _MAX_W:
        raise ValueError(f"trace_paths: {t} targets per net on a {h} x {w} "
                         f"plane; the kernel takes at most {MAX_TARGETS} on "
                         f"{_MAX_H - 1} x {_MAX_W - 1}")
    _build.launch(
        dist, _lib().trace_paths, "trace_paths",
        dist.data_ptr(), tgts.data_ptr(), tmask.data_ptr(), nmask.data_ptr(),
        occ.data_ptr(), routed.data_ptr(), failed.data_ptr(),
        wirelen.data_ptr(), b, t, h, w)
    count_launch("trace_paths")


def route_slots(occ0, hubs, tgts, tmask, nmask, grids, capacity: int,
                levels: torch.Tensor | None = None):
    """Route every net slot of a layout bucket, in one launch.

    occ0 (B, H, W) int32; hubs (B, S, 2) and tgts (B, S, T, 2) int32
    (gy, gx), inside their grid; tmask (B, S, T) and nmask (B, S) bool;
    grids (B, 2) int32.  Returns (occ (B, H, W) int32, routed, failed,
    wirelen (B,) int32); plain version `ref.route_slots_ref`.  On the
    card, `levels` (B,) int32, if given, receives each grid's BFS levels
    summed over its slots (the latency the launch runs through)."""
    b, h, w = occ0.shape
    s, t = tgts.shape[1], tgts.shape[2]
    _need(occ0, torch.int32, (b, h, w), "occ0")
    _need(hubs, torch.int32, (b, s, 2), "hubs")
    _need(tgts, torch.int32, (b, s, t, 2), "tgts")
    _need(tmask, torch.bool, (b, s, t), "tmask")
    _need(nmask, torch.bool, (b, s), "nmask")
    _need(grids, torch.int32, (b, 2), "grids")
    named = dict(occ0=occ0, hubs=hubs, tgts=tgts, tmask=tmask, nmask=nmask,
                 grids=grids)
    if levels is not None:
        _need(levels, torch.int32, (b,), "levels")
        named["levels"] = levels
    dev = _same_device(**named)
    ext = torch.minimum(grids, torch.tensor([h, w], dtype=torch.int32,
                                            device=dev))
    # lint: disable=host-sync -- checks the grids before a launch reads them
    if bool((ext < 1).any()):
        raise ValueError("route_slots: empty grid")
    lim = ext[:, None, :]
    # lint: disable=host-sync -- checks hubs and targets lie in their grids
    if bool(((hubs < 0) | (hubs >= lim)).any()
            | ((tgts < 0) | (tgts >= lim[:, :, None])).any()):
        raise ValueError("route_slots: a hub or target lies outside its grid")
    if dev.type == "cpu":
        if levels is not None:
            raise ValueError("route_slots: levels are counted on the card only")
        return ref.route_slots_ref(occ0, hubs, tgts, tmask, nmask, grids,
                                   capacity)
    if t > MAX_TARGETS or h >= _MAX_H or w >= _MAX_W:
        raise ValueError(f"route_slots: {t} targets per slot on a {h} x {w} "
                         f"plane exceed the kernel's limits (T <= "
                         f"{MAX_TARGETS}, H < {_MAX_H}, W < {_MAX_W})")
    # lint: disable=host-sync -- the most targets a grid routes: count width
    visits = int((tmask & nmask[..., None]).sum((1, 2)).max())
    wide = 2 * visits + 1 > _COUNT_MAX
    # lint: disable=host-sync -- each grid's extent places its state (smem)
    g = ext.cpu().numpy().astype(np.int64)
    words = g[:, 0] * ((g[:, 1] + 31) // 32)
    if int(words.max()) >= _MAX_WORDS:
        raise ValueError(f"route_slots: a grid has {int(words.max())} bitset "
                         f"words; the kernel takes fewer than {_MAX_WORDS}")
    lib = _lib()
    # Shared memory holds the bitsets of the grids whose bitsets fit it,
    # then the uint16 counts of those of them whose counts fit what is
    # left; the rest goes to the device-memory scratch, one slot per grid.
    # uint32 counts (`wide`) all go to the scratch.
    limit = lib.maze_route_smem_limit()
    bfit = 4 * _ROUTE_BITSETS * words <= limit
    smem_words = int(words[bfit].max()) if bfit.any() else 0
    cells = g[:, 0] * g[:, 1]
    cells += cells % 2                      # counts come in uint16 pairs
    cfit = bfit & (_ROUTE_CELL_BYTES * cells
                   <= limit - 4 * _ROUTE_BITSETS * smem_words) & (not wide)
    smem_cells = int(cells[cfit].max()) if cfit.any() else 0
    scratch_cells = int(cells[~cfit].max()) if (~cfit).any() else 0
    scratch_words = int(words[~bfit].max()) if (~bfit).any() else 0
    g_cnt = torch.empty(b * scratch_cells,
                        dtype=torch.int32 if wide else torch.int16, device=dev)
    g_bits = torch.empty(b * _ROUTE_BITSETS * scratch_words,
                         dtype=torch.int32, device=dev)
    occ = torch.empty_like(occ0)
    routed, failed, wirelen = (torch.empty(b, dtype=torch.int32, device=dev)
                               for _ in range(3))
    _build.launch(
        occ0, lib.route_slots, "route_slots",
        occ0.data_ptr(), hubs.data_ptr(), tgts.data_ptr(), tmask.data_ptr(),
        nmask.data_ptr(), grids.data_ptr(), occ.data_ptr(), routed.data_ptr(),
        failed.data_ptr(), wirelen.data_ptr(),
        None if levels is None else levels.data_ptr(),
        g_cnt.data_ptr() if scratch_cells else None,
        g_bits.data_ptr() if scratch_words else None, b, s, t, h, w,
        int(capacity), visits, int(wide), smem_cells, smem_words,
        scratch_cells, scratch_words)
    count_launch("route_slots")
    return occ, routed, failed, wirelen
