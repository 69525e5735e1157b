"""Fig. 9 reproduction: the explored design space, categorized by array
size / H / L / B_ADC, with the paper's qualitative trends asserted
quantitatively:
  (a)(b) larger arrays -> higher attainable SNR & throughput; smaller ->
         better energy & area;
  (c)(d) smaller H -> higher throughput, lower SNR, more area;
  (e)(f) smaller L -> higher throughput, higher SNR bound, more area;
  (g)(h) smaller B_ADC -> better energy efficiency, lower SNR.

Counterpart of `benchmarks/fig9_design_space.py`, with its rows and
trend keys.  The sizes are explored in one `DesignSession.fronts_for`
dispatch (on the card one `nsga2_evolve` launch for all of them); the
trends are the estimator's, on the device.

  PYTHONPATH=src python -m repro_torch.paper.fig9_design_space [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import DesignRequest, DesignSession
from repro_torch.core import estimator
from repro_torch.device import resolve_device
from repro_torch.paper.shared import device_args, fmt


def requests(sizes, pop: int, gens: int) -> list[DesignRequest]:
    """The figure's requests: one a size, seeded with the size."""
    return [DesignRequest(array_size=s, seed=s, pop_size=pop,
                          generations=gens, layout=False) for s in sizes]


def run(sizes=(4096, 16384, 65536), pop=192, gens=60, *, device=None,
        session: DesignSession | None = None) -> dict:
    """{size: the front's summary}.  `session` is the session to explore
    on (its front cache then holds the fronts), by default a new one on
    `device`."""
    session = session or DesignSession(device=resolve_device(device))
    fronts = session.fronts_for(requests(sizes, pop, gens))
    out = {}
    for req, res in fronts.items():
        m = res.metrics
        out[req.array_size] = {
            "n_pareto": len(res),
            "snr_max": float(np.max(m["snr_db"])),
            "tops_max": float(np.max(m["tops"])),
            "tops_per_w_max": float(np.max(m["tops_per_w"])),
            "area_min": float(np.min(m["area_f2_per_bit"])),
            "area_max": float(np.max(m["area_f2_per_bit"])),
        }
    return out


def trend_checks(*, device=None) -> dict:
    """Single-variable sweeps at 16 kb (paper Fig. 9 c-h).

    Note on (c)(d): at fixed (L, B_ADC), Eq. 7 is H-independent (H*W = S
    cancels: T = S/(L*t)).  The paper's "smaller H -> higher throughput /
    limited SNR" trend is mediated by the constraint B_ADC <= log2(H/L):
    small H caps the ADC precision, shortening the cycle (more T) and
    capping SNR.  We therefore sweep H with B at its constraint maximum —
    the Pareto-edge coupling Fig. 9 actually shows.
    """
    dev = resolve_device(device)

    def t(*v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def host(x):
        return x.cpu().numpy()

    s = 16384
    h = t(64, 128, 256, 512, 1024)
    w = s / h
    b_max = torch.log2(h / 8.0)                 # L = 8 in this sweep
    t_h = host(estimator.throughput_ops(h, w, t(8), b_max))
    snr_h = host(estimator.snr_total_db(h, t(8), b_max))
    a_h = host(estimator.area_f2_per_bit(h, t(8), t(3)))

    l = t(2, 4, 8, 16, 32)
    t_l = host(estimator.throughput_ops(t(512), t(32), l, t(3)))
    # SNR *upper bound* vs L (paper e/f): B at its constraint max
    snr_l = host(estimator.snr_total_db(t(512), l, torch.minimum(
        torch.log2(512.0 / l), t(8))))
    a_l = host(estimator.area_f2_per_bit(t(512), l, t(3)))

    b = t(1, 2, 3, 4, 5)
    e_b = host(estimator.energy_efficiency_tops_w(t(512), t(8), b))
    snr_b = host(estimator.snr_total_db(t(512), t(8), b))

    def mono(x, increasing):
        d = np.diff(x)
        return bool(np.all(d > 0) if increasing else np.all(d < 0))

    return {
        "smaller_H_higher_T": mono(t_h, False),       # T falls as H grows
        "smaller_H_lower_SNR": mono(snr_h, True),     # SNR cap rises with H
        "smaller_H_more_area": mono(a_h, False),
        "smaller_L_higher_T": mono(t_l, False),
        "smaller_L_higher_SNR": mono(snr_l, False),
        "smaller_L_more_area": mono(a_l, False),
        "smaller_B_better_EE": mono(e_b, False),
        "smaller_B_lower_SNR": mono(snr_b, True),
    }


def main(argv=None) -> None:
    args = device_args(argv, __doc__)
    for s, row in run(device=args.device).items():
        print(f"size={s}," + fmt(row))
    for k, v in trend_checks(device=args.device).items():
        print(f"trend,{k},{v}")


if __name__ == "__main__":
    main()
