"""The paper drivers, one section per table/figure, printed as CSV.

Counterpart of `benchmarks/run.py`:

  PYTHONPATH=src python -m repro_torch.paper.run [--skip fig9,...]
                                                 [--device cpu]

Sections:
  fig8   — 16 kb layout design points (throughput/area/SNR vs paper)
  fig9   — design-space sweep + monotone trend checks
  fig10  — EE/area span + SOTA comparison
  table2 — flow wall-clock comparison
  snr_mc — Monte-Carlo SNR vs analytical model (Eqs. 2-6)
  roofline — dry-run roofline table (from runs/dryrun_torch)

The reference's `kernels` section (its Pallas microbenchmarks) has no
section here: the port's kernel timings belong to its own benchmark.
A section that fails stops the run with its error.
"""
from __future__ import annotations

import argparse

from repro_torch.paper import (fig8_layouts, fig9_design_space, fig10_sota,
                               roofline, snr_mc, table2_flow)

SECTIONS = {
    "fig8": ("fig8_layouts", fig8_layouts.main),
    "fig9": ("fig9_design_space", fig9_design_space.main),
    "fig10": ("fig10_sota", fig10_sota.main),
    "table2": ("table2_flow", table2_flow.main),
    "snr_mc": ("snr_model_vs_mc", snr_mc.main),
}


def _section(name: str) -> None:
    print(f"\n#### {name}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip", default="", help="comma-separated sections")
    ap.add_argument("--device", default=None,
                    help="where the drivers run (default cuda)")
    args = ap.parse_args(argv)
    skip = set(args.skip.split(",")) if args.skip else set()
    dev = [] if args.device is None else ["--device", args.device]
    for key, (name, fn) in SECTIONS.items():
        if key not in skip:
            _section(name)
            fn(dev)
    if "roofline" not in skip:
        _section("roofline (from runs/dryrun_torch)")
        roofline.main([])


if __name__ == "__main__":
    main()
