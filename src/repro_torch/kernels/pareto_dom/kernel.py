"""`ctypes` wrappers of the pareto_dom CUDA kernels (`csrc/pareto_dom.cu`).

`nds_rank` replaces `repro.kernels.pareto_dom.kernel.nds_rank_kernel`
(fused dominance + bit-pack + front peel, one CTA per cell) and
`dominance_matrix` replaces `dominance_matrix_kernel` (tiled boolean
matrix).  Each takes a cell batch.  For a tensor on the CPU the wrapper
runs the plain version (`ref.py`); for a CUDA tensor it launches the
kernel, counts the launch in `repro_torch.kernels.LAUNCHES`, and
raises on a launch error.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.pareto_dom import ref

# Shared memory one block may use on Hopper (bytes).
SMEM_LIMIT = 232448

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("pareto_dom")
        p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.nds_rank_smem_bytes.argtypes = [i, i, i]
        lib.nds_rank_smem_bytes.restype = sz
        lib.nds_rank.argtypes = [p, p, p, i, i, i, i, p]
        lib.nds_rank.restype = i
        lib.dominance_matrix.argtypes = [p, p, i, i, i, p]
        lib.dominance_matrix.restype = i
        _LIB = lib
    return _LIB


def _check_f(f: torch.Tensor) -> None:
    if f.dim() != 3 or f.dtype != torch.float32 or not f.is_contiguous():
        raise ValueError(f"expected contiguous (C, P, M) float32 objectives, "
                         f"got {tuple(f.shape)} {f.dtype}")


def nds_rank(f: torch.Tensor) -> torch.Tensor:
    """f: (C, P, M) float32 with P % 32 == 0 (pad with +inf rows; see
    ops).  Returns (C, P) int32 non-dominated-sort front indices."""
    _check_f(f)
    c, p, m = f.shape
    if p % 32:
        raise ValueError(f"nds_rank needs P % 32 == 0, got P={p}")
    if f.device.type == "cpu":
        return ref.non_dominated_rank_ref(f)
    lib = _lib()
    packed_in_smem = int(lib.nds_rank_smem_bytes(p, m, 1) <= SMEM_LIMIT)
    if lib.nds_rank_smem_bytes(p, m, 0) > SMEM_LIMIT:
        raise ValueError(f"nds_rank: P={p}, M={m} exceeds shared memory")
    ranks = torch.empty((c, p), dtype=torch.int32, device=f.device)
    scratch = (torch.empty(0, dtype=torch.int32, device=f.device)
               if packed_in_smem else
               torch.empty((c, p // 32, p), dtype=torch.int32, device=f.device))
    rc = lib.nds_rank(f.data_ptr(), ranks.data_ptr(), scratch.data_ptr(),
                      c, p, m, packed_in_smem, _build.stream_ptr(f))
    _build.check(rc, "nds_rank")
    LAUNCHES["nds_rank"] += 1
    return ranks


def dominance_matrix(f: torch.Tensor) -> torch.Tensor:
    """f: (C, P, M) float32.  Returns (C, P, P) bool, D[c, i, j] = point
    i dominates point j."""
    _check_f(f)
    if f.device.type == "cpu":
        return ref.dominance_matrix_ref(f)
    c, p, m = f.shape
    out = torch.empty((c, p, p), dtype=torch.bool, device=f.device)
    rc = _lib().dominance_matrix(f.data_ptr(), out.data_ptr(), c, p, m,
                                 _build.stream_ptr(f))
    _build.check(rc, "dominance_matrix")
    LAUNCHES["dominance_matrix"] += 1
    return out
