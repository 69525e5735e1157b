"""NSGA-II (Deb et al.) for the EasyACIM design space, on torch tensors.

Counterpart of `repro.core.nsga2`.  The reference `vmap`s one traced
generation program over cells; here the cells are a leading batch
dimension written out: genes are (C, P, 3) int32, objectives (C, P, 4)
float32, and every per-cell operand (`SpaceOperands`) has a leading C.
There is no tracing, so nothing counts traces.

Randomness comes in as explicit tensors.  Each stochastic operator
takes its draws — the initial `randint` columns, the tournament pairs,
and the crossover / swap / mutation masks and mutation values — from a
draw source (`PhiloxDraws` in production: one `torch.Generator` per
cell, seeded from the cell's seed, so a cell's front never depends on
the cells it was batched with).  Tests hand the same operators draws
made with `jax.random` under the reference's key splits and require
bit-equal generations.

`evolve_from` makes every generation's draws at once (`generations`,
the same calls in the same order) and runs all generations in one
`nsga2_evolve` call: on CUDA one kernel launch for the cell batch, which
the reference's traced `fori_loop` corresponds to; `evolve_composite` is
the same loop one operator at a time, the kernel's plain version.

Gene encoding (all powers of two, matching the binary-ratioed CDAC):
    gene[0] = h_exp   -> H = 2**h_exp
    gene[1] = l_exp   -> L = 2**l_exp
    gene[2] = b_adc
W is implied by H*W = array_size; the inequality constraints
(H >= L, H/L >= 2^B) are kept by repair (clamping).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import estimator, pareto
from repro_torch.core.constants import CAL28, CalibConstants
from repro_torch.device import resolve_device
from repro_torch.kernels.pareto_dom import ops as dom_ops

DEFAULT_CROSSOVER_PROB = 0.9
DEFAULT_MUTATION_PROB = 0.2


@dataclasses.dataclass(frozen=True)
class NSGA2Config:
    """One NSGA-II run: the array size and the calibration fix the gene
    box (`space_operands`); the rest is the budget, as the reference's
    config (`run`, `EvolveStatics.from_config`)."""

    array_size: int
    pop_size: int = 256
    generations: int = 80
    crossover_prob: float = DEFAULT_CROSSOVER_PROB
    mutation_prob: float = DEFAULT_MUTATION_PROB
    tournament_pairs: int = 2
    seed: int = 0
    cal: CalibConstants = CAL28
    use_pallas_dominance: bool = False  # the dominance_matrix kernel's route
    use_pallas_rank: bool = False       # the fused rank kernel's route

    @property
    def log2_size(self) -> int:
        s = int(np.log2(self.array_size))
        if 2**s != self.array_size:
            raise ValueError("array_size must be a power of two")
        return s

    @property
    def h_exp_bounds(self) -> tuple[int, int]:
        lo = int(np.log2(self.cal.h_min))
        hi = min(int(np.log2(self.cal.h_max)),
                 self.log2_size - int(np.log2(self.cal.w_min)))
        return lo, hi

    @property
    def l_exp_bounds(self) -> tuple[int, int]:
        return int(np.log2(self.cal.l_min)), int(np.log2(self.cal.l_max))

    @property
    def b_bounds(self) -> tuple[int, int]:
        return self.cal.b_min, self.cal.b_max


class SpaceOperands(NamedTuple):
    """Per-cell design-space operands; batched, every leaf has a leading
    cell dimension C."""

    array_size: torch.Tensor            # (C,) float32
    gene_lo: torch.Tensor               # (C, 3) int32 lower bounds
    gene_hi: torch.Tensor               # (C, 3) int32 upper bounds (inclusive)
    cal: estimator.CalOperands          # leaves (C,) float32

    def to(self, device) -> "SpaceOperands":
        return SpaceOperands(self.array_size.to(device),
                             self.gene_lo.to(device), self.gene_hi.to(device),
                             self.cal.to(device))


class EvolveStatics(NamedTuple):
    """Structural NSGA-II parameters (population size, probabilities,
    kernel selection)."""

    pop_size: int = 256
    crossover_prob: float = DEFAULT_CROSSOVER_PROB
    mutation_prob: float = DEFAULT_MUTATION_PROB
    use_pallas_dominance: bool = False
    use_pallas_rank: bool = False

    @classmethod
    def from_config(cls, cfg: NSGA2Config) -> "EvolveStatics":
        return cls(pop_size=cfg.pop_size, crossover_prob=cfg.crossover_prob,
                   mutation_prob=cfg.mutation_prob,
                   use_pallas_dominance=cfg.use_pallas_dominance,
                   use_pallas_rank=cfg.use_pallas_rank)


class Population(NamedTuple):
    genes: torch.Tensor   # (P, 3) int32  [h_exp, l_exp, b]
    objs: torch.Tensor    # (P, 4) float32, minimization orientation


def space_operands(cfg: NSGA2Config) -> SpaceOperands:
    """One cell's operands (no batch dimension); see `stack_spaces`."""
    h_lo, h_hi = cfg.h_exp_bounds
    l_lo, l_hi = cfg.l_exp_bounds
    b_lo, b_hi = cfg.b_bounds
    return SpaceOperands(
        array_size=torch.tensor(float(cfg.array_size), dtype=torch.float32),
        gene_lo=torch.tensor([h_lo, l_lo, b_lo], dtype=torch.int32),
        gene_hi=torch.tensor([h_hi, l_hi, b_hi], dtype=torch.int32),
        cal=estimator.cal_operands(cfg.cal))


def stack_spaces(spaces) -> SpaceOperands:
    """Stack per-cell operands into one batch (leading dim C)."""
    spaces = list(spaces)
    return SpaceOperands(
        torch.stack([s.array_size for s in spaces]),
        torch.stack([s.gene_lo for s in spaces]),
        torch.stack([s.gene_hi for s in spaces]),
        estimator.CalOperands(*(torch.stack(leaves) for leaves
                                in zip(*(s.cal for s in spaces)))))


# ----------------------------------------------------------------------
# Draws: every random number an operator consumes, as tensors
# ----------------------------------------------------------------------
class GenerationDraws(NamedTuple):
    """One generation's random numbers for a cell batch; stacked over
    generations (`generations`), every field has a leading G."""

    pairs: torch.Tensor     # (C, n, 2) int64 tournament contestants in [0, P)
    do_cx: torch.Tensor     # (C, P, 1) bool  crossover per child
    swap: torch.Tensor      # (C, P, 3) bool  take the mate's gene
    u: torch.Tensor         # (C, P, 3) float32 in [0, 1), mutation values
    mut: torch.Tensor       # (C, P, 3) bool  mutate this gene


def stack_generations(per_gen, c: int, n: int, p: int,
                      device) -> GenerationDraws:
    """Stack GenerationDraws along a new leading G axis (G may be 0)."""
    if per_gen:
        return GenerationDraws(*(torch.stack(x) for x in zip(*per_gen)))
    kw = dict(device=device)
    return GenerationDraws(
        torch.zeros((0, c, n, 2), dtype=torch.int64, **kw),
        torch.zeros((0, c, p, 1), dtype=torch.bool, **kw),
        torch.zeros((0, c, p, 3), dtype=torch.bool, **kw),
        torch.zeros((0, c, p, 3), dtype=torch.float32, **kw),
        torch.zeros((0, c, p, 3), dtype=torch.bool, **kw))


class StackedDraws:
    """Draw source over draws made beforehand: `generation` hands out the
    slices of a stacked GenerationDraws in order."""

    def __init__(self, stacked: GenerationDraws):
        self.stacked = stacked
        self.next = 0

    def generation(self, n: int, p: int,
                   statics: EvolveStatics) -> GenerationDraws:
        d = GenerationDraws(*(x[self.next] for x in self.stacked))
        if d.pairs.shape[1] != n or d.u.shape[1] != p:
            raise ValueError(f"stacked draws are for n={d.pairs.shape[1]}, "
                             f"p={d.u.shape[1]}, not n={n}, p={p}")
        self.next += 1
        return d


class PhiloxDraws:
    """Production draw source: one `torch.Generator` per cell on the
    device (Philox on CUDA), seeded with the cell's seed."""

    def __init__(self, seeds, device):
        self.device = torch.device(device)
        self.gens = [torch.Generator(device=self.device).manual_seed(int(s))
                     for s in seeds]

    def init(self, lo: np.ndarray, hi: np.ndarray, pop: int) -> torch.Tensor:
        """(C, pop, 3) genes, column k uniform in [lo[c, k], hi[c, k]]."""
        return torch.stack([
            torch.stack([torch.randint(int(lo[c, k]), int(hi[c, k]) + 1,
                                       (pop,), generator=g,
                                       device=self.device)
                         for k in range(3)], -1)
            for c, g in enumerate(self.gens)]).to(torch.int32)

    def generation(self, n: int, p: int,
                   statics: EvolveStatics) -> GenerationDraws:
        def per_cell(g):
            kw = dict(generator=g, device=self.device)
            return (torch.randint(0, p, (n, 2), **kw),
                    torch.rand((p, 1), **kw) < statics.crossover_prob,
                    torch.rand((p, 3), **kw) < 0.5,
                    torch.rand((p, 3), **kw),
                    torch.rand((p, 3), **kw) < statics.mutation_prob)
        return GenerationDraws(*(torch.stack(x) for x in
                                 zip(*(per_cell(g) for g in self.gens))))

    def generations(self, n_gens: int, n: int, p: int,
                    statics: EvolveStatics) -> GenerationDraws:
        """Every generation's draws, stacked on a leading G axis: the same
        `generation` calls in the same order as the composite loop makes
        them, so the streams (and the fronts) are the same."""
        return stack_generations(
            [self.generation(n, p, statics) for _ in range(n_gens)],
            len(self.gens), n, p, self.device)


# ----------------------------------------------------------------------
# Operators (batched over cells)
# ----------------------------------------------------------------------
def repair_op(genes: torch.Tensor, space: SpaceOperands) -> torch.Tensor:
    """Project (C, P, 3) genes onto the feasible set (Eq. 12)."""
    lo = space.gene_lo[:, None, :]
    hi = space.gene_hi[:, None, :]
    h = torch.clamp(genes[..., 0], lo[..., 0], hi[..., 0])
    l = torch.clamp(genes[..., 1], lo[..., 1],
                    torch.minimum(hi[..., 1], h - lo[..., 2]))
    b = torch.clamp(genes[..., 2], lo[..., 2],
                    torch.minimum(hi[..., 2], h - l))
    return torch.stack([h, l, b], -1).to(torch.int32)


def decode_op(genes: torch.Tensor, space: SpaceOperands):
    """Genes -> (H, W, L, B) float32, each (C, P)."""
    h = torch.bitwise_left_shift(torch.ones_like(genes[..., 0]),
                                 genes[..., 0]).to(torch.float32)
    w = space.array_size[:, None] / h
    l = torch.bitwise_left_shift(torch.ones_like(genes[..., 1]),
                                 genes[..., 1]).to(torch.float32)
    b = genes[..., 2].to(torch.float32)
    return h, w, l, b


def evaluate_op(genes: torch.Tensor, space: SpaceOperands) -> torch.Tensor:
    h, w, l, b = decode_op(genes, space)
    cal = estimator.CalOperands(*(x[:, None] for x in space.cal))
    return estimator.objectives_from_operands(h, w, l, b, cal)


def init_population_op(draws: torch.Tensor,
                       space: SpaceOperands) -> torch.Tensor:
    """Repair the (C, pop, 3) initial `randint` columns."""
    return repair_op(draws, space)


def rank_and_crowd(objs: torch.Tensor, statics: EvolveStatics):
    """(ranks, crowding) of a (C, P, M) population.

    On CUDA the ranks come from the fused `nds_rank` kernel, except
    with `use_pallas_dominance` and not `use_pallas_rank`, which takes
    the `dominance_matrix` kernel and the torch peel.  Every route gives
    the same ranks."""
    if statics.use_pallas_dominance and not statics.use_pallas_rank:
        ranks = pareto.non_dominated_rank(
            objs, dom=dom_ops.dominance_matrix(objs))
    else:
        ranks = dom_ops.non_dominated_rank(objs)
    return ranks, pareto.crowding_distance(objs, ranks)


def _tournament(pairs: torch.Tensor, ranks: torch.Tensor,
                crowd: torch.Tensor) -> torch.Tensor:
    """Binary tournament on (rank asc, crowding desc); (C, n) winners."""
    a, b = pairs[..., 0], pairs[..., 1]
    ra, rb = ranks.gather(1, a), ranks.gather(1, b)
    ca, cb = crowd.gather(1, a), crowd.gather(1, b)
    a_better = (ra < rb) | ((ra == rb) & (ca > cb))
    return torch.where(a_better, a, b)


def _variation_op(d: GenerationDraws, parents: torch.Tensor,
                  space: SpaceOperands) -> torch.Tensor:
    """Uniform crossover + random-reset mutation on integer genes."""
    p = parents.shape[1]
    mates = parents[:, torch.roll(torch.arange(p, device=parents.device), 1)]
    children = torch.where(d.do_cx & d.swap, mates, parents)
    lo = space.gene_lo[:, None, :]
    hi = space.gene_hi[:, None, :]
    rand_gene = lo + (d.u * (hi - lo + 1).to(torch.float32)).to(torch.int32)
    children = torch.where(d.mut, rand_gene, children)
    return repair_op(children, space)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (C, P, ...) rows idx (C, n) -> (C, n, ...)."""
    shaped = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return x.gather(1, shaped.expand(idx.shape + x.shape[2:]))


def generation_step_op(d: GenerationDraws, genes, objs, ranks, crowd,
                       space: SpaceOperands, statics: EvolveStatics):
    """One NSGA-II generation with (ranks, crowd) carried.

    Environmental selection ranks the combined 2P pool once and keeps
    the first P by (rank asc, crowding desc); survivors keep their exact
    ranks and get their crowding recomputed."""
    parents_idx = _tournament(d.pairs, ranks, crowd)
    children = _variation_op(d, _gather_rows(genes, parents_idx), space)
    child_objs = evaluate_op(children, space)
    comb_genes = torch.cat([genes, children], 1)
    comb_objs = torch.cat([objs, child_objs], 1)
    comb_ranks, comb_crowd = rank_and_crowd(comb_objs, statics)
    keep = pareto.lexsort2(-comb_crowd, comb_ranks)[:, :statics.pop_size]
    genes_k = _gather_rows(comb_genes, keep)
    objs_k = _gather_rows(comb_objs, keep)
    ranks_k = comb_ranks.gather(1, keep)
    crowd_k = pareto.crowding_distance(objs_k, ranks_k)
    return genes_k, objs_k, ranks_k, crowd_k


def evolve_composite(draws, genes, objs, space: SpaceOperands,
                     statics: EvolveStatics, n_gens: int):
    """Rank once, then evolve `n_gens` generations, one torch operator
    (and, on CUDA, one rank kernel launch) at a time, taking each
    generation's draws from `draws.generation`.  Returns the final
    (genes, objs, ranks).  The plain version of `nsga2_evolve`."""
    ranks, crowd = rank_and_crowd(objs, statics)
    for _ in range(n_gens):
        d = draws.generation(statics.pop_size, genes.shape[1], statics)
        genes, objs, ranks, crowd = generation_step_op(
            d, genes, objs, ranks, crowd, space, statics)
    return genes, objs, ranks


def evolve_from(draws, genes, objs, space: SpaceOperands,
                statics: EvolveStatics, n_gens: int):
    """Rank once, then evolve `n_gens` generations: every generation's
    draws made at once, then one `nsga2_evolve` call (on CUDA one kernel
    launch for the whole batch; on the CPU `evolve_composite`).  The
    `use_pallas_dominance` without `use_pallas_rank` route keeps the
    composite loop, whose ranks take the `dominance_matrix` kernel."""
    if statics.use_pallas_dominance and not statics.use_pallas_rank:
        return evolve_composite(draws, genes, objs, space, statics,
                                n_gens)[:2]
    stacked = draws.generations(n_gens, statics.pop_size, genes.shape[1],
                                statics)
    return dom_ops.nsga2_evolve(stacked, genes, objs, space, statics)[:2]


def run_cell(draws, space: SpaceOperands, *, statics: EvolveStatics,
             n_gens: int):
    """One full NSGA-II run for a batch of cells: (genes, objs) of the
    final populations, (C, P, 3) and (C, P, 4)."""
    genes = init_population_op(
        draws.init(space.gene_lo.cpu().numpy(), space.gene_hi.cpu().numpy(),
                   statics.pop_size).to(space.gene_lo.device), space)
    objs = evaluate_op(genes, space)
    return evolve_from(draws, genes, objs, space, statics, n_gens)


def run(cfg: NSGA2Config, seed: int | None = None, *, draws=None,
        device=None) -> Population:
    """Full NSGA-II run of one cell; returns the final population
    (feasible by repair).  The reference takes a `jax.random` key; here
    the draws come from Philox seeded with `seed` (`cfg.seed` when None)
    on `device` (`cuda` when None: one `nsga2_evolve` launch), or from a
    draw source `draws` (with `init` and `generations`, as
    `PhiloxDraws`)."""
    dev = resolve_device(device)
    if draws is None:
        draws = PhiloxDraws([cfg.seed if seed is None else seed], dev)
    genes, objs = run_cell(draws, _one_space(cfg, dev),
                           statics=EvolveStatics.from_config(cfg),
                           n_gens=cfg.generations)
    return Population(genes[0], objs[0])


# ----------------------------------------------------------------------
# Config-static forms of one cell (the reference's compatibility
# wrappers): (P, 3) genes, no cell dimension, on the genes' device.
# ----------------------------------------------------------------------
def _one_space(cfg: NSGA2Config, device) -> SpaceOperands:
    return stack_spaces([space_operands(cfg)]).to(device)


def repair(genes: torch.Tensor, cfg: NSGA2Config) -> torch.Tensor:
    return repair_op(genes[None], _one_space(cfg, genes.device))[0]


def decode(genes: torch.Tensor, cfg: NSGA2Config):
    return tuple(x[0] for x in
                 decode_op(genes[None], _one_space(cfg, genes.device)))


def evaluate(genes: torch.Tensor, cfg: NSGA2Config) -> torch.Tensor:
    """Objectives of (P, 3) genes of one cell."""
    return evaluate_op(genes[None], _one_space(cfg, genes.device))[0]


def init_population(draws, cfg: NSGA2Config, *, device=None) -> torch.Tensor:
    """(pop_size, 3) repaired initial genes.  `draws` is a seed (Philox on
    `device`, `cuda` when None) or the (pop_size, 3) `randint` columns,
    each uniform in its gene box (the reference draws them from
    `jax.random.split(key, 3)`)."""
    if not isinstance(draws, torch.Tensor):
        sp = space_operands(cfg)
        draws = PhiloxDraws([int(draws)], resolve_device(device)).init(
            sp.gene_lo.numpy()[None], sp.gene_hi.numpy()[None],
            cfg.pop_size)[0]
    return repair(draws.to(torch.int32), cfg)


def constraint_violation(genes: torch.Tensor,
                         cfg: NSGA2Config) -> torch.Tensor:
    """Total violation (0 for feasible) — used by the constrained-dom path."""
    h, l, b = genes[:, 0], genes[:, 1], genes[:, 2]
    v1 = torch.clamp(l - h, min=0)            # H >= L
    v2 = torch.clamp(b - (h - l), min=0)      # H/L >= 2^B
    return (v1 + v2).to(torch.float32)


def generation_step(draws, genes: torch.Tensor, objs: torch.Tensor,
                    cfg: NSGA2Config):
    """One NSGA-II generation of one cell: rank the parents, select, vary,
    evaluate, truncate.  `draws` is a seed (Philox on the genes' device)
    or a `GenerationDraws` (one cell's, or a batch of one).  Returns the
    next (genes, objs)."""
    statics = EvolveStatics.from_config(cfg)
    p = genes.shape[0]
    if not isinstance(draws, GenerationDraws):
        draws = PhiloxDraws([int(draws)], genes.device).generation(
            statics.pop_size, p, statics)
    elif draws.pairs.dim() == 2:
        draws = GenerationDraws(*(x[None] for x in draws))
    ranks, crowd = rank_and_crowd(objs[None], statics)
    out = generation_step_op(draws, genes[None], objs[None], ranks, crowd,
                             _one_space(cfg, genes.device), statics)
    return out[0][0], out[1][0]

