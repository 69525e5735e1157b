"""EasyACIM core in PyTorch: the estimation model (Eqs. 2-11), Pareto
utilities and the NSGA-II design-space explorer."""
from repro_torch.core.acim_spec import MacroSpec, valid_spec
from repro_torch.core.constants import CAL28, CalibConstants

__all__ = ["MacroSpec", "valid_spec", "CAL28", "CalibConstants"]
