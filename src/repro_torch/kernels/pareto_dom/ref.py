"""Plain PyTorch versions of the pareto_dom kernels (`repro_torch.core.pareto`
and the composite NSGA-II loop of `repro_torch.core.nsga2`)."""
from repro_torch.core.pareto import crowding_distance as crowding_distance_ref
from repro_torch.core.pareto import dominance_matrix as dominance_matrix_ref
from repro_torch.core.pareto import non_dominated_rank as non_dominated_rank_ref

__all__ = ["dominance_matrix_ref", "non_dominated_rank_ref",
           "crowding_distance_ref", "nsga2_evolve_ref"]


def nsga2_evolve_ref(draws, genes, objs, space, statics):
    """`nsga2.evolve_composite` over stacked draws (leading G): the final
    (genes, objs, ranks)."""
    from repro_torch.core import nsga2  # deferred: nsga2 imports this family

    return nsga2.evolve_composite(nsga2.StackedDraws(draws), genes, objs,
                                  space, statics, draws.u.shape[0])
