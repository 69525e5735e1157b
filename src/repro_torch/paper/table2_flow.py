"""Table 2 reproduction: design-flow comparison (wall-clock, automation).

Counterpart of `benchmarks/table2_flow.py`, with its keys.  Paper:
traditional flow 1-2 months manual; AutoDCIM automatic layout from
user-fixed parameters; EasyACIM explores the Pareto frontier
automatically and generates layouts in "several hours" (exploration <
30 min, layout minutes/solution).  Here both stages are measured on the
device: the 16 kb exploration through `DesignSession.run` (on the card
one `nsga2_evolve` launch), then the sequential layout flow of two of
its specs (one `wavefront` launch a net).  `main()` prints the card's
name and power limit beside the times.

  PYTHONPATH=src python -m repro_torch.paper.table2_flow [--device cpu]
"""
from __future__ import annotations

from repro_torch.api import DesignRequest, DesignSession
from repro_torch.device import resolve_device
from repro_torch.eda.flow import generate_layout
from repro_torch.paper.shared import card_line, clock, device_args

REQUEST = DesignRequest(array_size=16384, pop_size=192, generations=60,
                        layout=False)


def run(*, device=None, session: DesignSession | None = None) -> dict:
    """The table's row.  `session` is the session to explore on (its
    front cache then holds the front), by default a new one on
    `device`."""
    dev = resolve_device(device)
    session = session or DesignSession(device=dev)
    t0 = clock(dev)
    res = session.run(REQUEST).pareto
    t_explore = clock(dev) - t0

    sel = res.filter(min_tops=0.5).specs[:2] or res.specs[:2]
    t0 = clock(dev)
    for spec in sel:
        generate_layout(spec, device=dev)
    t_layout = (clock(dev) - t0) / max(len(sel), 1)

    return {
        "explore_seconds": round(t_explore, 2),
        "paper_explore_seconds": 1800.0,
        "explore_speedup_vs_paper": round(1800.0 / max(t_explore, 1e-9), 1),
        "layout_seconds_per_solution": round(t_layout, 2),
        "paper_layout_seconds": 180.0,
        "pareto_points": len(res),
        "parameters_determined_automatically": True,
        "layout_automatic": True,
    }


def main(argv=None) -> None:
    args = device_args(argv, __doc__)
    for k, v in run(device=args.device).items():
        print(f"{k}={v}")
    print(card_line(args.device))


if __name__ == "__main__":
    main()
