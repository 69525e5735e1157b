"""Plain PyTorch version of the acim_matmul kernel.

Delegates to `repro_torch.core.acim_numerics.acim_matmul_ref`, the
behavioral model of the macro, exactly as the reference's oracle does.
"""
from __future__ import annotations

import torch

from repro_torch.core import acim_numerics
from repro_torch.core.acim_spec import MacroSpec


def acim_matmul_ref(x: torch.Tensor, w: torch.Tensor, *, n: int,
                    b_adc: int) -> torch.Tensor:
    """Ideal (noiseless) ACIM GEMM; x (..., K), w (K, C)."""
    h = n * 2  # any (h, l) with h/l == n is equivalent for the numerics
    spec = MacroSpec(h=h, w=w.shape[-1], l=2, b_adc=b_adc)
    return acim_numerics.acim_matmul_ref(x, w, spec)
