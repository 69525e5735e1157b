"""Pareto dominance utilities (paper Sec. 2.2, Eq. 1) on torch tensors.

Counterpart of `repro.core.pareto`.  Every function takes objectives
`f` of shape (..., P, M) with any number of leading batch dimensions
(the explorer's cells), so one call ranks a whole cell batch.  These
are the plain versions of the `repro_torch.kernels.pareto_dom` kernels.
"""
from __future__ import annotations

import torch

INF = float("inf")
_BIG = 1e30          # crowding distance of a front's boundary points


def dominance_matrix(f: torch.Tensor) -> torch.Tensor:
    """D[..., i, j] = True iff point i dominates point j.  f: (..., P, M)."""
    a = f[..., :, None, :]
    b = f[..., None, :, :]
    return (a <= b).all(-1) & (a < b).any(-1)


def non_dominated_mask(f: torch.Tensor) -> torch.Tensor:
    """(..., P) True where no other point dominates this one."""
    return ~dominance_matrix(f).any(-2)


def non_dominated_rank(f: torch.Tensor,
                       dom: torch.Tensor | None = None) -> torch.Tensor:
    """Fast non-dominated sort: (..., P) int32 front index (0 = Pareto).

    Peels fronts: the points whose count of not-yet-peeled dominators is
    zero form the next front.  The count is an integer sum over the
    boolean matrix, so it is exact with no float matmul precision to
    choose.  One host check per front ends the loop once every cell of
    the batch is ranked (the reference's vmapped `while_loop`)."""
    if dom is None:
        dom = dominance_matrix(f)
    ranks = torch.full(f.shape[:-1], -1, dtype=torch.int32, device=f.device)
    front = 0
    while True:
        alive = ranks < 0
        if not bool(alive.any()):
            return ranks
        indeg = (dom & alive[..., :, None]).sum(-2)
        ranks = torch.where(alive & (indeg == 0), front, ranks).to(torch.int32)
        front += 1


def lexsort2(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """Indices that sort the last axis by `primary`, ties by `secondary`,
    remaining ties by position: `jnp.lexsort((secondary, primary))` as
    two stable sorts."""
    o1 = torch.argsort(secondary, dim=-1, stable=True)
    o2 = torch.argsort(primary.gather(-1, o1), dim=-1, stable=True)
    return o1.gather(-1, o2)


def crowding_distance(f: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """NSGA-II crowding distance per front, (..., P) float32.

    Per objective, points are sorted by (rank, value) so each front is
    contiguous; interior points get the gap between their neighbours
    over the front's span, boundary points get 1e30.  The per-objective
    distances are added in objective order, as the reference reduces
    them."""
    p, m = f.shape[-2], f.shape[-1]
    ranks = ranks.to(torch.int64)
    total = None
    for k in range(m):
        v = f[..., k]
        order = lexsort2(v, ranks)
        rs = ranks.gather(-1, order)
        vs = v.gather(-1, order)
        change = rs[..., 1:] != rs[..., :-1]
        edge = torch.ones_like(change[..., :1])
        seg_start = torch.cat([edge, change], -1)
        seg_end = torch.cat([change, edge], -1)
        prev = torch.cat([vs[..., :1], vs[..., :-1]], -1)
        nxt = torch.cat([vs[..., 1:], vs[..., -1:]], -1)
        fmin = torch.full(vs.shape[:-1] + (p,), INF, dtype=vs.dtype,
                          device=vs.device).scatter_reduce(-1, rs, vs, "amin")
        fmax = torch.full(vs.shape[:-1] + (p,), -INF, dtype=vs.dtype,
                          device=vs.device).scatter_reduce(-1, rs, vs, "amax")
        span = torch.clamp_min(fmax - fmin, 1e-12).gather(-1, rs)
        d = torch.where(seg_start | seg_end, _BIG, (nxt - prev) / span)
        d = torch.zeros_like(d).scatter(-1, order, d)
        total = d if total is None else total + d
    return total
