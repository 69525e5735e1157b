"""`ctypes` wrappers of the pareto_dom CUDA kernels (`csrc/pareto_dom.cu`).

`nds_rank` replaces `repro.kernels.pareto_dom.kernel.nds_rank_kernel`
(fused dominance + bit-pack + front peel, one CTA per cell) and
`dominance_matrix` replaces `dominance_matrix_kernel` (tiled boolean
matrix).  `nsga2_evolve` runs every NSGA-II generation of a cell batch
in one launch (the reference's `evolve_from` loop, whose rank is
`nds_rank_kernel`), on the same rank code as `nds_rank`.  Each takes a
cell batch.  For tensors on the CPU a wrapper runs the plain version
(`ref.py`); for CUDA tensors it launches the kernel, counts the launch
in `repro_torch.kernels.LAUNCHES`, and raises on a launch error.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.pareto_dom import ref

# nds_rank's and dominance_matrix's objectives per point are a
# compile-time count up to this.
MAX_OBJECTIVES = 8
# nsga2_evolve's sort keys hold a pool index in 16 bits: 2 P <= 2^16.
MAX_POP = 2 ** 15
# The calibration operands of a cell, in the kernel's `Cal` order after
# the array size.
_CAL_FIELDS = ("inv_pre", "adc_off_db", "t_com", "t_set_per_b",
               "t_conv_bit", "e_cc_fj", "k1_fj", "k2_fj", "log2_vdd", "vdd2",
               "a_sram", "a_lc", "a_comp", "a_dff")

_LIB = None
_LIB_LOCK = threading.Lock()   # first calls may race from several threads
# nds_rank's plan by (P, M): whether the packed dominance words fit shared
# memory (read from the library once, not on every call).
_RANK_PLAN: dict[tuple[int, int], bool] = {}


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = _build.load("pareto_dom")
        p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.pareto_dom_smem_limit.argtypes = []
        lib.pareto_dom_smem_limit.restype = i
        lib.nds_rank_smem_bytes.argtypes = [i, i, i]
        lib.nds_rank_smem_bytes.restype = sz
        lib.nds_rank.argtypes = [p, p, p, i, i, i, i, p]
        lib.nds_rank.restype = i
        lib.dominance_matrix.argtypes = [p, p, i, i, i, p]
        lib.dominance_matrix.restype = i
        lib.nsga2_evolve_bytes.argtypes = [i, i]
        lib.nsga2_evolve_bytes.restype = sz
        lib.nsga2_evolve.argtypes = [p] * 13 + [i] * 5 + [p]
        lib.nsga2_evolve.restype = i
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
    if not 1 <= m <= MAX_OBJECTIVES:
        raise ValueError(f"nds_rank takes 1 to {MAX_OBJECTIVES} objectives, "
                         f"got M={m}")
    lib = _lib()
    packed_in_smem = _RANK_PLAN.get((p, m))
    if packed_in_smem is None:
        limit = lib.pareto_dom_smem_limit()
        if lib.nds_rank_smem_bytes(p, m, 0) > limit:
            raise ValueError(f"nds_rank: P={p}, M={m} exceeds shared memory")
        packed_in_smem = _RANK_PLAN[(p, m)] = \
            lib.nds_rank_smem_bytes(p, m, 1) <= limit
    ranks = torch.empty((c, p), dtype=torch.int32, device=f.device)
    scratch = None if packed_in_smem else torch.empty(
        (c, p // 32, p), dtype=torch.int32, device=f.device)
    _build.launch(f, lib.nds_rank, "nds_rank", f.data_ptr(),
                  ranks.data_ptr(), None if scratch is None
                  else scratch.data_ptr(), c, p, m, int(packed_in_smem))
    count_launch("nds_rank")
    return ranks


def dominance_matrix(f: torch.Tensor) -> torch.Tensor:
    """f: (C, P, M) float32.  Returns (C, P, P) bool, D[c, i, j] = point
    i dominates point j."""
    _check_f(f)
    if f.device.type == "cpu":
        return ref.dominance_matrix_ref(f)
    c, p, m = f.shape
    if not 1 <= m <= MAX_OBJECTIVES:
        raise ValueError(f"dominance_matrix takes 1 to {MAX_OBJECTIVES} "
                         f"objectives, got M={m}")
    out = torch.empty((c, p, p), dtype=torch.bool, device=f.device)
    _build.launch(f, _lib().dominance_matrix, "dominance_matrix",
                  f.data_ptr(), out.data_ptr(), c, p, m)
    count_launch("dominance_matrix")
    return out


def _need(t: torch.Tensor, dtype, shape, name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)} (contiguous: "
                         f"{t.is_contiguous()})")


def evolve_operands(draws, space, p: int):
    """The kernel's inputs beside the population: (pairs (G, C, P, 2)
    int32, flags (G, C, P) uint8 (bit k: take the mate's gene k, bit 3 +
    k: mutate it), u (G, C, P, 3) float32, cal (C, 15) float32 (the array
    size, then `_CAL_FIELDS`), bounds (C, 6) int32 (gene_lo, gene_hi))."""
    dev = draws.u.device
    bit = torch.tensor([1, 2, 4], dtype=torch.int32, device=dev)
    flags = (((draws.do_cx & draws.swap).int() * bit).sum(-1)
             + ((draws.mut.int() * bit).sum(-1) << 3)).to(torch.uint8)
    cal = torch.stack([space.array_size]
                      + [getattr(space.cal, k) for k in _CAL_FIELDS], -1)
    bounds = torch.cat([space.gene_lo, space.gene_hi], -1)
    return (draws.pairs.to(torch.int32).contiguous(), flags.contiguous(),
            draws.u.contiguous(), cal.to(torch.float32).contiguous(),
            bounds.to(torch.int32).contiguous())


def nsga2_evolve(draws, genes: torch.Tensor, objs: torch.Tensor, space,
                 statics, fronts: torch.Tensor | None = None):
    """Every NSGA-II generation of C cells: rank and crowd the (C, P)
    population, then G generations of tournament, variation, repair,
    objectives and (rank, crowding) selection on `draws` (a stacked
    `nsga2.GenerationDraws`, leading G).  Returns the final (genes (C, P,
    3) int32, objs (C, P, 4) float32, ranks (C, P) int32), bit-equal to
    the plain version `ref.nsga2_evolve_ref` (the composite loop) on the
    same draws.  On the card, `fronts` (C,) int32, if given, receives the
    fronts each cell peeled over all its ranks (the launch's latency
    count)."""
    c, p = genes.shape[:2]
    g = draws.u.shape[0]
    _need(genes, torch.int32, (c, p, 3), "genes")
    _need(objs, torch.float32, (c, p, 4), "objs")
    if statics.pop_size != p:
        raise ValueError(f"pop_size {statics.pop_size} != population {p}")
    shapes = dict(pairs=(g, c, p, 2), do_cx=(g, c, p, 1), swap=(g, c, p, 3),
                  u=(g, c, p, 3), mut=(g, c, p, 3))
    for name, shape in shapes.items():
        if tuple(getattr(draws, name).shape) != shape:
            raise ValueError(f"draws.{name}: expected {shape}, got "
                             f"{tuple(getattr(draws, name).shape)}")
    devs = {genes.device, objs.device, space.gene_lo.device,
            *(x.device for x in draws)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    if genes.device.type == "cpu":
        if fronts is not None:
            raise ValueError("nsga2_evolve: fronts are counted on the card "
                             "only")
        return ref.nsga2_evolve_ref(draws, genes, objs, space, statics)
    if fronts is not None:
        _need(fronts, torch.int32, (c,), "fronts")
    if p > MAX_POP:
        raise ValueError(f"nsga2_evolve takes pop_size <= {MAX_POP}, got {p}")
    # lint: disable=host-sync -- checks the tournament indices before a launch
    if g and bool(((draws.pairs < 0) | (draws.pairs >= p)).any()):
        raise ValueError("nsga2_evolve: a tournament index lies outside "
                         "the population")
    pairs, flags, u, cal, bounds = evolve_operands(draws, space, p)
    lib = _lib()
    # Shared memory holds the state and the dominance words where both
    # fit, else the state alone; the rest goes to device-memory scratch.
    limit = lib.pareto_dom_smem_limit()
    state, packed = lib.nsga2_evolve_bytes(p, 0), lib.nsga2_evolve_bytes(p, 1)
    state_in_smem = state <= limit
    packed_in_smem = state + packed <= limit
    g_state = None if state_in_smem else torch.empty(
        c * state, dtype=torch.uint8, device=genes.device)
    g_packed = None if packed_in_smem else torch.empty(
        c * packed, dtype=torch.uint8, device=genes.device)
    out_g = torch.empty_like(genes)
    out_o = torch.empty_like(objs)
    ranks = torch.empty((c, p), dtype=torch.int32, device=genes.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch(
        genes, lib.nsga2_evolve, "nsga2_evolve",
        genes.data_ptr(), objs.data_ptr(), pairs.data_ptr(), flags.data_ptr(),
        u.data_ptr(), cal.data_ptr(), bounds.data_ptr(), out_g.data_ptr(),
        out_o.data_ptr(), ranks.data_ptr(), ptr(fronts), ptr(g_state),
        ptr(g_packed), c, p, g, int(state_in_smem), int(packed_in_smem))
    count_launch("nsga2_evolve")
    return out_g, out_o, ranks
