"""Monte-Carlo validation of the analytical SNR model (paper Eqs. 2-6).

Counterpart of `benchmarks/snr_mc.py`, with its lines.  Simulates the QR
macro (ADC quantization + Eq. 5 mismatch/thermal noise) on random 1b
data and compares measured SNR to `estimator.snr_total_db` across (N,
B_ADC) operating points.  The noisy product is the macro's plain
simulation (`core.acim_numerics.acim_matmul_ref` with noise, as the
reference's); the noiseless one is exactly what the `acim_matmul` kernel
computes, so it runs there (on the card one launch a point).

  PYTHONPATH=src python -m repro_torch.paper.snr_mc [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import acim_numerics as an
from repro_torch.core import estimator
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.device import resolve_device
from repro_torch.kernels.acim_matmul.ops import acim_matmul
from repro_torch.paper.shared import device_args

POINTS = [(128, 2, 3), (128, 2, 5), (512, 8, 4), (256, 2, 6), (1024, 32, 5)]


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def operands(spec: MacroSpec, *, rows: int = 256, cols: int = 64,
             seed: int = 0, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The +-1 operands x (rows, N) and w (N, cols), each entry +1 with
    probability 1/2, from generators seeded with `seed` and `seed + 1`
    (the reference's first two keys)."""
    dev = resolve_device(device)
    k = spec.n_caps
    x = torch.where(torch.rand((rows, k), generator=_generator(dev, seed),
                               device=dev) < 0.5, 1.0, -1.0)
    w = torch.where(torch.rand((k, cols), generator=_generator(dev, seed + 1),
                               device=dev) < 0.5, 1.0, -1.0)
    return x, w


def noise_draws(spec: MacroSpec, *, rows: int = 256, cols: int = 64,
                seed: int = 0, device=None) -> an.NoiseDraws:
    """The standard normals of one noisy run: the static mismatch from a
    generator seeded with `seed + 2`, the thermal noise of each
    conversion from one seeded with `seed + 3` (the reference's instance
    and conversion keys)."""
    dev = resolve_device(device)
    mm = torch.randn((1, spec.n_caps, cols), generator=_generator(dev, seed + 2),
                     device=dev)
    th = torch.randn((rows, 1, cols), generator=_generator(dev, seed + 3),
                     device=dev)
    return an.NoiseDraws(mm, th)


def snr_db(ref: torch.Tensor, y: torch.Tensor) -> float:
    """10 log10(var(ref) / var(y - ref)), population variances in
    float32, the error's floored at 1e-12."""
    num = float(torch.var(ref, correction=0))
    return 10.0 * float(np.log10(num / max(
        float(torch.var(y - ref, correction=0)), 1e-12)))


def mc_snr_db(spec: MacroSpec, *, rows: int = 256, cols: int = 64,
              noisy: bool = True, seed: int = 0, device=None,
              x: torch.Tensor | None = None, w: torch.Tensor | None = None,
              draws: an.NoiseDraws | None = None) -> float:
    """The measured SNR of the macro `spec` on (rows, N) x (N, cols) +-1
    operands: `x` and `w` as given, else `operands`; with `noisy`, the
    noise's standard normals `draws` as given, else `noise_draws`."""
    dev = resolve_device(device)
    if x is None or w is None:
        x, w = operands(spec, rows=rows, cols=cols, seed=seed, device=dev)
    if noisy:
        if draws is None:
            draws = noise_draws(spec, rows=x.shape[0], cols=w.shape[1],
                                seed=seed, device=dev)
        y = an.acim_matmul_ref(x, w, spec, noise=an.NoiseParams.from_cal(),
                               draws=draws)
    else:
        y = acim_matmul(x, w, spec)
    return snr_db(x @ w, y)


def main(argv=None) -> None:
    args = device_args(argv, __doc__)
    print("h,l,b_adc,analytic_db,mc_db,delta_db")
    for h, l, b in POINTS:
        spec = MacroSpec(h, 64, l, b)
        ana = float(estimator.snr_total_db(h, l, b))
        mc = mc_snr_db(spec, device=args.device)
        print(f"{h},{l},{b},{ana:.2f},{mc:.2f},{mc - ana:+.2f}")


if __name__ == "__main__":
    main()
