from repro_torch.kernels.acim_matmul.ops import (acim_matmul, acim_matmul_ste,
                                                 mismatch_weights)
from repro_torch.kernels.acim_matmul.ref import acim_matmul_ref

__all__ = ["acim_matmul", "acim_matmul_ste", "acim_matmul_ref",
           "mismatch_weights"]
