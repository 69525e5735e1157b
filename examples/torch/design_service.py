"""Multi-tenant design service demo on the PyTorch port: concurrent
users, one dispatch.

Several tenants submit different `DesignRequest`s — different array
sizes, seeds, and application requirements — against a *running*
`DesignService` staged pipeline (`serve()`): submissions landing inside
the coalescing window are folded into one explore dispatch (on the card
one `nsga2_evolve` launch), the union of surviving specs is laid out in
streamed routing-grid-shape buckets (one `route_slots` launch each),
and each tenant blocks in `collect(timeout=...)` until its ticketed
artifact lands.  The closing stats line shows the per-stage busy clocks
and the explore∥layout overlap gauge.  The port's counterpart of
`examples/design_service.py`, with the same output.

A persistent artifact cache backs the session, so re-running this
script (same `--cache-dir`) serves every tenant from disk with zero
explorer dispatches — the provenance line flips to `artifact_cache`.
With `--telemetry-dir DIR` the service runs instrumented and dumps the
per-batch stage Gantt as Chrome-trace JSON plus a metrics snapshot,
both inspectable with `tools/repro_torch_ctl.py`.

  PYTHONPATH=src python examples/torch/design_service.py [--device cpu]
      [--smoke] [--cache-dir DIR] [--telemetry-dir DIR]

`--device` is where the service explores and lays out (default `cuda`);
`--smoke` takes pop 48 x 10 generations, small enough for the CPU.
"""
import argparse
import dataclasses
import pathlib

from repro_torch.api import DesignRequest, DesignSession, Requirements
from repro_torch.serve.design_service import DesignService
from repro_torch.telemetry import Telemetry, write_metrics_json

TENANTS = {
    "edge-snr": DesignRequest(
        array_size=4096, pop_size=96, generations=30,
        requirements=Requirements(min_snr_db=20.0)),
    "edge-tops": DesignRequest(
        array_size=4096, pop_size=96, generations=30, seed=1,
        requirements=Requirements(min_tops=0.5, min_snr_db=15.0)),
    # screening query: Pareto front only, no layouts
    "cloud-eff": DesignRequest(
        array_size=16384, pop_size=96, generations=30,
        requirements=Requirements(min_tops_per_w=100.0), layout=False),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="pop 48 x 10 generations")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent artifact-cache directory; re-run with "
                         "the same dir to be served from disk")
    ap.add_argument("--telemetry-dir", default=None,
                    help="dump the stage-span trace and metrics snapshot "
                         "here")
    args = ap.parse_args(argv)
    tenants = TENANTS
    if args.smoke:
        tenants = {name: dataclasses.replace(r, pop_size=48, generations=10)
                   for name, r in TENANTS.items()}

    session = DesignSession(artifact_cache=args.cache_dir, device=args.device)
    telemetry = Telemetry() if args.telemetry_dir else None
    with DesignService(session, coalesce_window_s=0.25,
                       telemetry=telemetry).serve() as svc:
        tickets = {name: svc.submit(req) for name, req in tenants.items()}
        arts = {name: svc.collect(t, timeout=600)
                for name, t in tickets.items()}

    for name, art in arts.items():
        p = art.provenance
        if not art.ok or not len(art.pareto):
            why = art.error or "requirements removed every point"
            print(f"{name:10s} ticket={tickets[name]} | no surviving "
                  f"solution ({why})")
            continue
        best = art.pareto.best("tops_per_w")
        laid = ("front only" if art.layout_rows is None
                else f"{p.layout_dispatches} layout bucket(s)")
        print(f"{name:10s} ticket={tickets[name]} | {len(art.pareto)} "
              f"survivors, best H={best.h} W={best.w} L={best.l} "
              f"B={best.b_adc} | served from {p.served_from}, coalesced "
              f"with {p.coalesced - 1} other request(s), {laid}")
    s = svc.stats()   # point-in-time snapshot: counters + pipeline gauges
    factor = (s["service_batch_requests"] / s["service_batches"]
              if s["service_batches"] else 0.0)
    print(f"\nservice: {s['requests_served']} requests -> "
          f"{s['service_batches']} batch(es) (coalescing factor "
          f"{factor:.1f}), {s['explorer_dispatches']} explorer "
          f"dispatch(es), {s['run_cell_traces']} sweep-program trace(s), "
          f"{s['layout_dispatches']} layout bucket dispatch(es), "
          f"{s['artifact_cache_hits']} artifact-cache hit(s)")
    busy = s["stage_busy_s"]
    print(f"pipeline: explore {busy['explore']:.3f}s / distill "
          f"{busy['distill']:.3f}s / layout {busy['layout']:.3f}s / "
          f"finalize {busy['finalize']:.3f}s busy, explore∥layout overlap "
          f"{s['pipeline_overlap_s']:.3f}s "
          f"(fraction {s['pipeline_overlap_fraction']:.2f})")

    if args.telemetry_dir:
        out = pathlib.Path(args.telemetry_dir)
        out.mkdir(parents=True, exist_ok=True)
        svc.trace().to_json(out / "service_trace.json")
        write_metrics_json(svc.metrics(), out / "service_metrics.json")
        print(f"telemetry: stage Gantt + metrics snapshot -> {out} "
              f"(inspect with tools/repro_torch_ctl.py)")


if __name__ == "__main__":
    main()
