from repro_torch.kernels.pareto_dom.ops import (dominance_matrix,
                                                non_dominated_rank)
from repro_torch.kernels.pareto_dom.ref import (crowding_distance_ref,
                                                dominance_matrix_ref,
                                                non_dominated_rank_ref)

__all__ = ["dominance_matrix", "non_dominated_rank",
           "dominance_matrix_ref", "non_dominated_rank_ref",
           "crowding_distance_ref"]
