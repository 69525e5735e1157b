"""Batched multi-cell NSGA-II sweep: the cells are a batch dimension.

Counterpart of `repro.core.batched_explorer`.  The reference `vmap`s
`nsga2.run_cell` over a stacked operand tree; here `nsga2.run_cell`
takes the stacked (C, ...) operands directly, so a whole (array_size,
seed) sweep is one batched run with one rank-and-crowd per generation
for all cells.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import nsga2
from repro_torch.core.constants import CAL28, CalibConstants


def sweep_program(seeds, spaces: nsga2.SpaceOperands, *,
                  statics: nsga2.EvolveStatics, n_gens: int):
    """The sweep: every cell's NSGA-II run, cells batched, with one
    Philox generator per cell seeded from its seed."""
    draws = nsga2.PhiloxDraws(seeds, spaces.gene_lo.device)
    return nsga2.run_cell(draws, spaces, statics=statics, n_gens=n_gens)


def explore_cells(cells, *, pop_size: int = 256, generations: int = 80,
                  crossover_prob: float = nsga2.DEFAULT_CROSSOVER_PROB,
                  mutation_prob: float = nsga2.DEFAULT_MUTATION_PROB,
                  cal: CalibConstants = CAL28,
                  use_pallas_dominance: bool = False,
                  use_pallas_rank: bool = False,
                  program=None, device="cuda") -> dict:
    """Sweep an explicit (array_size, seed) cell list in one batched run.

    Returns {(array_size, seed): ParetoResult}, each the deduplicated
    Pareto front of the cell's final population.  `program` optionally
    injects a sweep callable (seeds, spaces) -> (genes, objs) — the
    session's program cache — and defaults to `sweep_program`."""
    from repro_torch.core import explorer  # deferred: explorer wraps this module

    cells = list(dict.fromkeys((int(s), int(sd)) for s, sd in cells))
    if not cells:
        raise ValueError("explore_cells needs at least one (size, seed) cell")
    if program is None:
        statics = nsga2.EvolveStatics(
            pop_size=pop_size, crossover_prob=crossover_prob,
            mutation_prob=mutation_prob,
            use_pallas_dominance=use_pallas_dominance,
            use_pallas_rank=use_pallas_rank)
        program = functools.partial(sweep_program, statics=statics,
                                    n_gens=generations)
    spaces = nsga2.stack_spaces([
        nsga2.space_operands(nsga2.NSGA2Config(array_size=s, cal=cal))
        for s, _ in cells]).to(torch.device(device))
    genes_b, objs_b = program([sd for _, sd in cells], spaces)
    genes_b = genes_b.cpu().numpy()
    objs_b = objs_b.cpu().numpy()
    return {
        (s, sd): explorer.pareto_result_from_population(
            s, genes_b[i], objs_b[i], cal=cal)
        for i, (s, sd) in enumerate(cells)
    }
