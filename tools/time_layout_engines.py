"""Split the time of the layout layer's `wavefront` paths:

    python3 tools/time_layout_engines.py [--device cpu] [--reps N]

(1) The 16 kb front's whole bucket (86 specs padded to 1118 x 274) laid
out by the concurrent engine (`generate_layouts(engine="concurrent")`,
its schedule recorded): wall seconds, its schedule (rounds, rounds with
BFS lanes, BFS lanes, collisions, crossings), the bytes of BFS fields
copied back from the card, the seconds inside its field step
(`batched_flow._bfs_fields`; on the card: uploads, the `wavefront`
launch, the copy back into pinned memory and the host padding; on the
CPU: the frontier engine with early exit), on the card the device time
of the `wavefront` launches (CUDA events around each call), and the
rest, the host scheduler; then, on the card, the scan engine on the
same bucket.
(2) `flow.generate_layout` of the front's largest grid (MacroSpec(64,
256, 2, 5), 576 nets) and of a 2048-row spec (MacroSpec(2048, 8, 16,
1), 80 nets): wall seconds, seconds inside `router.route` and, within
it, inside its `wavefront_distance` calls (on the card: upload, launch,
copy back; on the CPU: the frontier engine), the rest of `route` being
the host backtrace; seconds in `drc_lite`; the rest is netlist and
placement.  The default device is the card, whose name and power limit
are printed first.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.core.acim_spec import MacroSpec  # noqa: E402
from repro_torch.eda import batched_flow as bf  # noqa: E402
from repro_torch.eda import flow, router  # noqa: E402

FLOW_SPECS = (MacroSpec(64, 256, 2, 5), MacroSpec(2048, 8, 16, 1))
clock: dict = {}


def timed(module, name: str, key: str, events: bool):
    """Wrap `module.name` so its calls add their host seconds (and, with
    `events`, their device ms from CUDA events) to `clock`."""
    fn = getattr(module, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        if events:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        out = fn(*a, **k)
        if events:
            end.record()
            end.synchronize()
            clock[key + "_device_ms"] = (clock.get(key + "_device_ms", 0.0)
                                         + start.elapsed_time(end))
        clock[key] = clock.get(key, 0.0) + time.perf_counter() - t0
        return out

    setattr(module, name, wrapper)


def sync(card: bool) -> None:
    if card:
        torch.cuda.synchronize()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    card = torch.device(args.device).type == "cuda"
    if card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        print(f"gpu: {smi.stdout.strip()}", flush=True)
        c.build_phase()
    specs = [MacroSpec(p["row"]["h"], p["row"]["w"], p["row"]["l"],
                       p["row"]["b_adc"]) for p in c.golden_points()]
    timed(bf, "_bfs_fields", "fields", False)
    timed(bf, "wavefront_distance", "wavefront", card)
    for rep in range(args.reps):
        clock.clear()
        t0 = time.perf_counter()
        res = bf.generate_layouts(specs, coarse=c.COARSE,
                                  capacity=c.CAPACITY, engine="concurrent",
                                  device=args.device, record_schedule=True)
        sync(card)
        wall = time.perf_counter() - t0
        sched = res.routing.schedule
        _, gh, gw = res.routing.occ_count.shape
        lanes = sum(sched.bfs_lanes)
        device = (f", wavefront device {clock['wavefront_device_ms']:.1f} ms"
                  if card else "")
        print(f"concurrent run {rep} on {args.device}: wall {wall:.3f} s; "
              f"{sched.rounds} rounds, {sum(1 for n in sched.bfs_lanes if n)} "
              f"with BFS lanes, {lanes} BFS lanes (at most "
              f"{max(sched.bfs_lanes)} a round), {sched.collisions} "
              f"collisions, {sched.crossings} crossings; bytes copied back "
              f"{lanes * gh * gw * 4 if card else 0}; field step "
              f"{clock['fields']:.3f} s{device}; scheduler and the rest "
              f"{wall - clock['fields']:.3f} s", flush=True)
        if card:     # the scan engine's plain version sweeps for hours
            t0 = time.perf_counter()
            bf.generate_layouts(specs, coarse=c.COARSE, capacity=c.CAPACITY,
                                engine="scan", device=args.device)
            sync(card)
            print(f"scan run {rep} on {args.device}: wall "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)

    timed(flow, "route", "route", False)
    timed(flow, "drc_lite", "drc", False)
    timed(router, "wavefront_distance", "net_fields", card)
    for spec in FLOW_SPECS:
        for rep in range(args.reps):
            clock.clear()
            t0 = time.perf_counter()
            lr = flow.generate_layout(spec, device=args.device)
            sync(card)
            wall = time.perf_counter() - t0
            device = (f", device {clock['net_fields_device_ms']:.1f} ms"
                      if card else "")
            print(f"flow {spec} run {rep} on {args.device}: wall {wall:.3f} "
                  f"s; route {clock['route']:.3f} s (wavefront calls "
                  f"{clock['net_fields']:.3f} s{device} over "
                  f"{len(lr.routing.wires) + len(lr.routing.failed)} nets; "
                  f"host backtrace {clock['route'] - clock['net_fields']:.3f}"
                  f" s); drc_lite {clock['drc']:.3f} s; netlist and "
                  f"placement {wall - clock['route'] - clock['drc']:.3f} s",
                  flush=True)


if __name__ == "__main__":
    main()
