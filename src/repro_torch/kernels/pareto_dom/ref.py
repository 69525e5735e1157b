"""Plain PyTorch versions of the pareto_dom kernels (`repro_torch.core.pareto`)."""
from repro_torch.core.pareto import crowding_distance as crowding_distance_ref
from repro_torch.core.pareto import dominance_matrix as dominance_matrix_ref
from repro_torch.core.pareto import non_dominated_rank as non_dominated_rank_ref

__all__ = ["dominance_matrix_ref", "non_dominated_rank_ref",
           "crowding_distance_ref"]
