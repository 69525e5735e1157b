"""CIM-in-the-loop linear layers: route a projection through the simulated
ACIM macro (quantization + ADC + analog mismatch) with straight-through
gradients, for models that will deploy on the generated macro.

y ~= s_x * s_w * MACRO(bin(x), bin(w))     (1b x 1b, paper Sec. 4 config)

Scales: per-tensor mean-|.| for activations, per-output-column for weights
(keeps the binary GEMM's dynamic range matched per column ADC).

Counterpart of `repro.quant.cim_linear`.  The static mismatch draw of a
macro instance depends only on (instance_seed, weight shape), as in the
reference, where every layer reuses `key(instance_seed)`.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.acim_numerics import NoiseParams
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.kernels.acim_matmul import acim_matmul_ste, mismatch_weights


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    spec: MacroSpec
    mismatch: bool = True           # fold static cap mismatch into weights
    instance_seed: int = 0


# One draw per (seed, shape, device), cached: every layer of one weight
# shape reuses it (the property of the reference's shared key), and a
# training step does not redraw it.  The draw is made on the CPU and
# copied, so every device sees the same numbers for the same seed.
@functools.lru_cache(maxsize=32)
def mismatch_eps(seed: int, shape: tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """Standard normals of `shape`: the static mismatch of macro
    instance `seed`."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device)


class _SignSTE(torch.autograd.Function):
    """+1 where x >= 0, else -1; clipped straight-through gradient
    (gradients pass inside |x| <= 1)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (torch.abs(x) <= 1.0).to(g.dtype)


def _sign_ste(x: torch.Tensor) -> torch.Tensor:
    return _SignSTE.apply(x)


def cim_linear(x: torch.Tensor, w: torch.Tensor, cim: CIMConfig | None, *,
               eps: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., K); w: (K, C).  cim=None -> exact matmul (digital path).
    `eps` (standard normals of w's shape) replaces the instance's
    mismatch draw `mismatch_eps(cim.instance_seed, w.shape, w.device)`."""
    if cim is None:
        return x @ w
    s_x = torch.mean(torch.abs(x)) + 1e-8
    s_w = torch.mean(torch.abs(w), dim=0, keepdim=True) + 1e-8   # per column
    bx = _sign_ste(x / s_x)
    bw = _sign_ste(w / s_w)
    if cim.mismatch:
        if eps is None:
            eps = mismatch_eps(cim.instance_seed, tuple(w.shape), w.device)
        bw_run = mismatch_weights(bw, cim.spec, eps, NoiseParams.from_cal())
        bw = bw + (bw_run - bw).detach()
    y = acim_matmul_ste(bx, bw, cim.spec)
    return y * s_x * s_w
