"""Fig. 8 reproduction: 16 kb ACIM layouts at three design specifications.

Counterpart of `benchmarks/fig8_layouts.py`, with its rows.  Paper
values: (a) H=128, L=2, B=3 -> 3.277 TOPS, 4504 F^2/bit; (b) balanced
-> 0.813 TOPS, 2610 F^2/bit; (c) same throughput, +3 dB SNR, 2977
F^2/bit.  The exact (H, W, L) of (b)/(c) are not published; the
estimator pins them to (512,32,8,3) and (256,64,8,3) (see
core/constants.py [T1]), which reproduce throughput to <1% and area to
-19%/-5%.  Each spec runs the sequential layout flow
(`eda.flow.generate_layout`: on the card one `wavefront` launch a net of
two or more pins), the estimator on the device.

  PYTHONPATH=src python -m repro_torch.paper.fig8_layouts [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.core import estimator
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.device import resolve_device
from repro_torch.eda.flow import generate_layout
from repro_torch.paper.shared import card_line, clock, device_args, fmt

PAPER = {
    "a": (MacroSpec(128, 128, 2, 3), 3.277, 4504.0),
    "b": (MacroSpec(512, 32, 8, 3), 0.813, 2610.0),
    "c": (MacroSpec(256, 64, 8, 3), 0.813, 2977.0),
}


def run(*, device=None) -> list[dict]:
    """The reference's rows; `layout_seconds` is the flow's wall-clock
    on `device`, read after the card's queued work."""
    dev = resolve_device(device)
    rows = []
    for tag, (spec, paper_tops, paper_area) in PAPER.items():
        t0 = clock(dev)
        lr = generate_layout(spec, device=dev)
        seconds = clock(dev) - t0
        m = lr.metrics()
        h, w, l, b = (torch.tensor(float(v), device=dev)
                      for v in spec.as_tuple())
        tops = float(estimator.throughput_ops(h, w, l, b)) / 1e12
        snr = float(estimator.snr_total_db(h, l, b))
        rows.append({
            "point": tag, "h": spec.h, "w": spec.w, "l": spec.l,
            "b_adc": spec.b_adc,
            "tops": tops, "paper_tops": paper_tops,
            "tops_err": tops / paper_tops - 1.0,
            "est_area": m["estimator_area_f2_per_bit"],
            "layout_area": m["layout_area_f2_per_bit"],
            "paper_area": paper_area,
            "area_err_est": m["estimator_area_f2_per_bit"] / paper_area - 1.0,
            "snr_db": snr,
            "drc_clean": m["drc_clean"],
            "route_success": m["route_success"],
            "layout_seconds": seconds,
        })
    return rows


def main(argv=None) -> None:
    args = device_args(argv, __doc__)
    for r in run(device=args.device):
        print(fmt(r))
    print(card_line(args.device))


if __name__ == "__main__":
    main()
