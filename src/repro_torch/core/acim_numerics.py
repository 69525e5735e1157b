"""Behavioral numerics of the synthesizable ACIM macro (paper Sec. 3.1).

Counterpart of `repro.core.acim_numerics`: the semantics of executing a
GEMM on the generated macro, used as the plain version of the
`acim_matmul` kernel (`repro_torch.kernels.acim_matmul.ref`) and by
`repro_torch.quant.cim_linear` for hardware-in-the-loop training.

Compute model (QR, Fig. 2(c) / Fig. 6):
  * Weights are stored bit-serially in the 8T array; activations are applied
    as RWL pulses.  Multi-bit operands run bit-serially with digital
    shift-add (`acim_matmul_multibit_ref`).
  * One ADC conversion digitizes the charge-redistributed average of
    N = H/L products.  In sum units the ADC input is s = sum_k x_k*w_k in
    [-N, N]; the B-bit mid-tread SAR quantizer has step delta = 2N/2^B.
  * Analog non-idealities (Eq. 5): static capacitor mismatch (a per-instance
    draw: the same hardware always errs the same way) and kT/C thermal
    noise per conversion.
  * K > N is tiled into ceil(K/N) chunks; inter-chunk accumulation is
    digital (exact), as in the real macro's output accumulator.

Randomness: torch cannot reproduce `jax.random` streams, so the noisy
simulation takes its standard-normal draws as explicit tensors
(`NoiseDraws`); with none given it draws them from a seeded
`torch.Generator`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import estimator
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.core.constants import CAL28, CalibConstants


@dataclasses.dataclass(frozen=True)
class NoiseParams:
    """Per-element (per 1b-product) relative noise std-devs, from Eq. 5."""

    mismatch_rel: float   # sigma(dC/C) = kappa / sqrt(C0_fF): static
    thermal_rel: float    # sqrt(2 kT / C0) / Vdd: per conversion
    prefactor: float      # (2/3)(1 - 4^-Bw) bit-weighting factor

    @staticmethod
    def from_cal(cal: CalibConstants = CAL28) -> "NoiseParams":
        c0_f = cal.c0_ff * 1e-15
        return NoiseParams(
            mismatch_rel=cal.kappa / float(np.sqrt(cal.c0_ff)),
            thermal_rel=float(np.sqrt(2.0 * cal.kt / c0_f)) / cal.v_dd,
            prefactor=(2.0 / 3.0) * (1.0 - 4.0 ** (-cal.b_w)),
        )


class NoiseDraws(NamedTuple):
    """Standard-normal draws of one noisy simulation."""

    mismatch: torch.Tensor   # (n_chunks, N, C): one per cap, static
    thermal: torch.Tensor    # (..., n_chunks, C): one per conversion


def adc_quantize_sum(s: torch.Tensor, n: int, b_adc: int) -> torch.Tensor:
    """B-bit mid-tread SAR quantization of a sum in [-N, N].

    delta = 2N / 2^B; codes round half to even and clip to
    [-(2^(B-1)), 2^(B-1) - 1] like a real two's-complement SAR register.
    Returns the *dequantized* sum (float).  The division is a true
    division on every device (a 0-d tensor divisor: CUDA turns a
    division by a Python scalar into a multiply by its reciprocal)."""
    delta = 2.0 * n / (2.0 ** b_adc)
    code = torch.round(s / torch.tensor(delta, dtype=s.dtype, device=s.device))
    code = code.clamp(-(2.0 ** (b_adc - 1)), 2.0 ** (b_adc - 1) - 1.0)
    return code * delta


def _pad_k(x: torch.Tensor, w: torch.Tensor, n: int):
    """Zero-pad the contraction dim to a multiple of the chunk size N.

    Zero-padding is what the hardware does: unused rows of the local array
    keep their caps at V_CM and contribute no charge.
    """
    k = x.shape[-1]
    k_pad = (-k) % n
    if k_pad:
        x = F.pad(x, (0, k_pad))
        w = F.pad(w, (0, 0, 0, k_pad))
    return x, w, (k + k_pad) // n


def draw_noise(lead: tuple, n_chunks: int, n: int, cols: int, *,
               generator: torch.Generator | None = None,
               device="cpu") -> NoiseDraws:
    """Standard normals for one noisy simulation, from `generator` (a
    CPU generator seeded with 0 when none is given), on `device`."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    mm = torch.randn((n_chunks, n, cols), generator=g)
    th = torch.randn((*lead, n_chunks, cols), generator=g)
    return NoiseDraws(mm.to(device), th.to(device))


def acim_matmul_ref(x: torch.Tensor, w: torch.Tensor, spec: MacroSpec, *,
                    noise: NoiseParams | None = None,
                    draws: NoiseDraws | None = None,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Simulate y = x @ w on the macro.  x: (..., K) in {-1, +1} (or any
    bounded analog value |x|<=1, the RWL pulse width); w: (K, C) in
    {-1, +1}.  Returns (..., C) float32.

    With `noise=None` the path is deterministic (ideal caps) and bit-exact
    against the kernel on +-1 operands.  With noise, `draws.mismatch`
    gives the static per-(chunk-position, column) capacitor mismatch and
    `draws.thermal` the per-conversion thermal noise, both standard
    normals; without `draws` they come from `generator` (`draw_noise`).
    """
    n, b = spec.n_caps, spec.b_adc
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    x, w, n_chunks = _pad_k(x, w, n)
    cols = w.shape[-1]
    xc = x.reshape(*x.shape[:-1], n_chunks, n)
    wc = w.reshape(n_chunks, n, cols)

    # partial sums per chunk: (..., n_chunks, cols)
    s = torch.einsum("...ck,ckj->...cj", xc, wc)

    if noise is not None:
        if draws is None:
            draws = draw_noise(tuple(s.shape[:-2]), n_chunks, n, cols,
                               generator=generator, device=s.device)
        # static mismatch: eps per (chunk, k, col) cap; the error is
        # sum_k q_k eps_k over the actual products q.
        eps = noise.mismatch_rel * draws.mismatch
        q = xc[..., None] * wc            # (..., c, k, j) products: memory
        err_mm = torch.sum(q * eps, dim=-2)   # heavy, plain version only
        sigma_th = noise.thermal_rel * float(np.sqrt(n))  # sum-referred kT/C
        err_th = sigma_th * draws.thermal
        pref = float(np.sqrt(noise.prefactor))
        s = s + pref * (err_mm + err_th)

    y_hat = adc_quantize_sum(s, n, b)
    return torch.sum(y_hat, dim=-2)


def acim_matmul_multibit_ref(x_int: torch.Tensor, w_int: torch.Tensor,
                             spec: MacroSpec, b_x: int, b_w: int
                             ) -> torch.Tensor:
    """Bit-serial multi-bit GEMM on the macro (digital shift-add of 1b planes).

    x_int: (..., K) signed ints in [-2^(bx-1), 2^(bx-1)-1]; w_int likewise.

    Bipolar recoding keeps every plane in the macro's native {-1,+1} domain:
    with offset-binary bits u_i of (v + 2^(b-1)) and p_i = 2*u_i - 1,
        v = sum_i p_i 2^(i-1) - 1/2 .
    Expanding x.w therefore gives
        y = sum_ij 2^(i+j-2) <px_i, pw_j>  - (sum_x + sum_w)/2 - K/4 ,
    where the cross terms <px_i, pw_j> run on the macro (ADC-quantized) and
    the rank-1 corrections are exact digital arithmetic.
    """
    def planes(v, bits):
        u = v.to(torch.int32) + 2 ** (bits - 1)           # offset binary
        return [(((u >> i) & 1) * 2 - 1).to(torch.float32) for i in range(bits)]

    xs = planes(x_int, b_x)
    ws = planes(w_int, b_w)
    k = x_int.shape[-1]

    total = 0.0
    for i, px in enumerate(xs):
        for j, pw in enumerate(ws):
            total = total + 2.0 ** (i + j - 2) * acim_matmul_ref(px, pw, spec)
    sum_x = torch.sum(x_int.to(torch.float32), dim=-1, keepdim=True)
    sum_w = torch.sum(w_int.to(torch.float32), dim=0, keepdim=True)
    return total - 0.5 * sum_x - 0.5 * sum_w - k / 4.0


def quantize_symmetric(x: torch.Tensor, bits: int):
    """Per-tensor symmetric quantization to signed `bits` ints (QAT-style)."""
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-8)
    scale = amax / (2.0 ** (bits - 1) - 1.0)
    q = torch.clamp(torch.round(x / scale), -(2.0 ** (bits - 1)),
                    2.0 ** (bits - 1) - 1.0)
    return q.to(torch.int32), scale


def binarize(x: torch.Tensor):
    """Sign binarization with per-tensor scale (1b weights/activations)."""
    scale = torch.mean(torch.abs(x)) + 1e-8
    return torch.where(x >= 0, 1.0, -1.0).to(torch.float32), scale


def expected_snr_db(spec: MacroSpec, cal: CalibConstants = CAL28) -> float:
    return float(estimator.snr_total_db(spec.h, spec.l, spec.b_adc, cal))
