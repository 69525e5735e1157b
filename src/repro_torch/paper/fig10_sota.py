"""Fig. 10 reproduction: EasyACIM design space vs SOTA ACIMs on the
(energy efficiency, area) plane.

Counterpart of `benchmarks/fig10_sota.py`, with its keys.  Paper claims
the generated space spans 50-750 TOPS/W and 1500-7500 F^2/bit, with a
Pareto frontier competitive with designs A [4], B [5], C [8].  SOTA
reference points (energy-eff TOPS/W, area F^2/bit) are taken at the
1b-normalized operating points reported in those papers.  The sizes are
explored in one `DesignSession.fronts_for` dispatch (on the card one
`nsga2_evolve` launch), the pooled 2-D front by `core.pareto
.non_dominated_mask` on the device.

  PYTHONPATH=src python -m repro_torch.paper.fig10_sota [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import DesignRequest, DesignSession
from repro_torch.core.pareto import non_dominated_mask
from repro_torch.device import resolve_device
from repro_torch.paper.shared import device_args

# (label, tops_per_w, area_f2_per_bit) — 1b-normalized literature points
SOTA = [
    ("A_JSSC23_bitflex", 588.0, 6300.0),
    ("B_JSSC22_colADC", 49.3, 3000.0),
    ("C_ISSCC20_7nm", 351.0, 4100.0),
]

PAPER_EE_RANGE = (50.0, 750.0)
PAPER_AREA_RANGE = (1500.0, 7500.0)


def requests(sizes) -> list[DesignRequest]:
    """The figure's requests: one a size, seeded with the size + 17."""
    return [DesignRequest(array_size=s, seed=s + 17, pop_size=192,
                          generations=60, layout=False) for s in sizes]


def run(sizes=(4096, 16384, 65536), *, device=None,
        session: DesignSession | None = None) -> dict:
    """The span of the sizes' pooled fronts, its 2-D front and the SOTA
    points it dominates.  `session` as `fig9_design_space.run`'s."""
    dev = resolve_device(device)
    session = session or DesignSession(device=dev)
    fronts = session.fronts_for(requests(sizes))
    ee, area = [], []
    for res in fronts.values():
        ee.extend(res.metrics["tops_per_w"].tolist())
        area.extend(res.metrics["area_f2_per_bit"].tolist())
    ee = np.array(ee)
    area = np.array(area)
    # 2D Pareto front on (maximize EE, minimize area), in float32 as the
    # reference's
    f = torch.stack([-torch.tensor(ee, dtype=torch.float32, device=dev),
                     torch.tensor(area, dtype=torch.float32, device=dev)],
                    dim=-1)
    front = non_dominated_mask(f).cpu().numpy()

    def dominated_by_ours(pt):
        e, a = pt
        return bool(np.any((ee >= e) & (area <= a)))

    return {
        "ee_min": float(ee.min()), "ee_max": float(ee.max()),
        "area_min": float(area.min()), "area_max": float(area.max()),
        "ee_span_covers_paper": bool(ee.min() <= PAPER_EE_RANGE[0] * 1.2
                                     and ee.max() >= PAPER_EE_RANGE[1] * 0.8),
        "area_span_covers_paper": bool(area.min() <= PAPER_AREA_RANGE[0] * 1.2
                                       and area.max() >= PAPER_AREA_RANGE[1] * 0.8),
        "n_front": int(front.sum()),
        "sota_matched": {label: dominated_by_ours((e, a))
                         for label, e, a in SOTA},
    }


def main(argv=None) -> None:
    args = device_args(argv, __doc__)
    for k, v in run(device=args.device).items():
        print(f"{k}={v}")


if __name__ == "__main__":
    main()
