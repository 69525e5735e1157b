"""Public acim_matmul entry points: fold the leading dims into M, zero-pad
K to a multiple of the chunk size N (zero rows are caps held at V_CM,
contributing no charge; on the mma route to a multiple of 4 too: a
chunk of zeros converts to exactly 0) and, on the tensor-core routes, C
to a multiple of 4, call the kernel wrapper (which picks the route);
fold the static capacitor mismatch (Eq. 5) into the weights; and a
straight-through gradient so the simulated macro can sit inside a
training graph (`repro_torch.quant.cim_linear`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.acim_numerics import NoiseParams
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.kernels.acim_matmul import kernel


def mismatch_weights(w: torch.Tensor, spec: MacroSpec, eps: torch.Tensor,
                     noise: NoiseParams) -> torch.Tensor:
    """Fold the static per-cap mismatch into the weights: the QR error
    sum_k q_k eps_k is exactly a matmul with w * (1 + sqrt(pref) * eps').
    `eps` holds standard normals of `w`'s shape (the instance's draw)."""
    return w * (1.0 + float(np.sqrt(noise.prefactor)) * noise.mismatch_rel
                * eps)


def acim_matmul(x: torch.Tensor, w: torch.Tensor,
                spec: MacroSpec) -> torch.Tensor:
    """Simulated y = x @ w on the macro; x (..., K), w (K, C) in [-1, 1].
    Returns (..., C) float32, bit-exact against `ref.acim_matmul_ref` on
    +-1 operands for any shape."""
    n, b_adc = spec.n_caps, spec.b_adc
    lead = x.shape[:-1]
    k = x.shape[-1]
    c = w.shape[-1]
    xm = x.reshape(-1, k).to(torch.float32)
    wm = w.to(torch.float32)
    route = kernel.route(n)
    # The tensor-core routes load rows as 16-byte vectors: zero columns to
    # a multiple of 4, cut off again below (and on the mma route K too).
    pad = (-k) % (max(n, 4) if route == "mma" else n)
    if pad:
        xm = F.pad(xm, (0, pad))
        wm = F.pad(wm, (0, 0, 0, pad))
    cpad = (-c) % 4 if route in ("wgmma", "mma") else 0
    if cpad:
        wm = F.pad(wm, (0, cpad))
    y = kernel.acim_matmul(xm.contiguous(), wm.contiguous(), n, b_adc)
    if cpad:
        y = y[:, :c]
    return y.reshape(*lead, c)


class _AcimSTE(torch.autograd.Function):
    """Forward: the macro (the kernel).  Backward: the gradient of the
    ideal matmul, as the reference's custom VJP computes it outside any
    kernel: gx = g w^T, gw = x^T g summed over the leading dims."""

    @staticmethod
    def forward(ctx, x, w, spec):
        ctx.save_for_backward(x, w)
        return acim_matmul(x, w, spec)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = torch.matmul(g, w.t().to(g.dtype))
        gw = torch.matmul(x.reshape(-1, x.shape[-1]).t().to(g.dtype),
                          g.reshape(-1, g.shape[-1]))
        return gx.to(x.dtype), gw.to(w.dtype), None


def acim_matmul_ste(x: torch.Tensor, w: torch.Tensor,
                    spec: MacroSpec) -> torch.Tensor:
    """ACIM matmul with a straight-through gradient (d y / d(x,w) of the
    ideal matmul), the standard estimator for quantization-in-the-loop
    training."""
    return _AcimSTE.apply(x, w, spec)
