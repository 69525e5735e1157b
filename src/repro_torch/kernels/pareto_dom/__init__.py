from repro_torch.kernels.pareto_dom.ops import (dominance_matrix,
                                                non_dominated_rank,
                                                nsga2_evolve, rank_and_crowd)
from repro_torch.kernels.pareto_dom.ref import (crowding_distance_ref,
                                                dominance_matrix_ref,
                                                non_dominated_rank_ref,
                                                nsga2_evolve_ref)

__all__ = ["dominance_matrix", "non_dominated_rank", "nsga2_evolve",
           "rank_and_crowd",
           "dominance_matrix_ref", "non_dominated_rank_ref",
           "crowding_distance_ref", "nsga2_evolve_ref"]
