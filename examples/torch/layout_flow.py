"""Reproduce the paper's Fig. 8 on the PyTorch port: three 16 kb ACIM
layouts at different design specifications, through the *batched*
layout path — netlist stats, placement, routing and DRC for all three
specs in one dispatch chain (`repro_torch.api.DesignSession.layout`),
the way a distilled Pareto set is laid out.  `--full` also runs the
sequential `repro_torch.eda.flow.generate_layout` per spec and exports
full GDS-like JSON (named cells + wire geometry).  The port's
counterpart of `examples/layout_flow.py`, with the same output.

  PYTHONPATH=src python examples/torch/layout_flow.py [--device cpu]
                                                      [--smoke] [--full]

`--device` is where the layout runs (default `cuda`); `--smoke` lays
out spec (a) only, small enough for the CPU.
"""
import argparse
import pathlib
import time

from repro_torch.api import DesignSession
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.eda.flow import generate_layout

# (spec, paper TOPS, paper F^2/bit) — see benchmarks/fig8_layouts.py
PAPER = {
    "a": (MacroSpec(128, 128, 2, 3), 3.277, 4504.0),
    "b": (MacroSpec(512, 32, 8, 3), 0.813, 2610.0),
    "c": (MacroSpec(256, 64, 8, 3), 0.813, 2977.0),
}

OUT = pathlib.Path("runs/fig8_torch")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="lay out spec (a) only")
    ap.add_argument("--full", action="store_true",
                    help="also the sequential flow's full layout JSON")
    args = ap.parse_args(argv)
    OUT.mkdir(parents=True, exist_ok=True)
    paper = dict(list(PAPER.items())[:1]) if args.smoke else PAPER
    specs = [spec for spec, _, _ in paper.values()]
    t0 = time.perf_counter()
    res = DesignSession(device=args.device).layout(specs)
    elapsed = time.perf_counter() - t0
    res.to_json(OUT / "fig8_batched.json")
    for (tag, (spec, _, paper_area)), m in zip(paper.items(),
                                               res.metrics_rows()):
        print(f"({tag}) H={spec.h} W={spec.w} L={spec.l} B={spec.b_adc}: "
              f"layout {m['layout_area_f2_per_bit']:.0f} F^2/bit "
              f"(paper {paper_area:.0f}), routed {m['routed_nets']} nets, "
              f"DRC clean={m['drc_clean']}")
    print(f"batched: {len(specs)} layouts in {elapsed:.1f}s "
          f"-> {OUT}/fig8_batched.json")
    if args.full:
        for tag, (spec, _, _) in paper.items():
            lr = generate_layout(spec, device=args.device)
            lr.to_json(OUT / f"fig8_{tag}.json")
            print(f"({tag}) full layout JSON ({len(lr.placement.rects)} "
                  f"cells, {len(lr.routing.wires)} wires) in "
                  f"{lr.metrics()['elapsed_s']:.1f}s")


if __name__ == "__main__":
    main()
