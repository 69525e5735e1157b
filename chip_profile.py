#!/usr/bin/env python3
"""Where the time of the port's 16 kb main path goes, on one GPU.

    python3 chip_profile.py

Run from the root of a checkout on a machine with a CUDA device (it
builds the kernels on first use, like `chip_smoke.py`).  After one
warm-up request it runs `DesignSession().run(DesignRequest(16384))` at
the default budget once under `torch.profiler` (CPU + CUDA activity)
and prints:

1. the request's explore and layout seconds, as its provenance reports
   them;
2. the layout flow's stages (`layout.place`, `layout.drc`,
   `layout.nets`, `layout.route`: the profiler ranges of
   `repro_torch.eda.batched_flow.generate_layouts`), each with its host
   time and the device time of its annotation where the profiler
   records one;
3. the device kernels and copies with the most time, their counts, and
   their summed time against the wall time (the device's busy share;
   the rest is host time the device idles through).

It checks nothing: `chip_smoke.py` holds the results against the
golden rows.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARRAY_SIZE = 16384
STAGE_PREFIX = "layout."


def profile_request(request) -> dict:
    """One request under the profiler: provenance times, the layout
    stages' ranges, the top device entries and the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import DesignSession

    session = DesignSession()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        art = session.run(request)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages: dict[str, dict] = {}
    kernels = []
    for e in prof.key_averages():
        if e.key.startswith(STAGE_PREFIX):
            # A range appears once on the host and, where the profiler
            # annotates the device too, once more as a device row.
            st = stages.setdefault(e.key[len(STAGE_PREFIX):],
                                   {"host_ms": 0.0, "device_ms": None})
            if e.device_type == DeviceType.CUDA:
                st["device_ms"] = e.device_time_total / 1e3
            else:
                st["host_ms"] = e.cpu_time_total / 1e3
        elif (e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0):
            # Only device events are summed: a CPU operator's row
            # repeats the time of the kernels it launched.
            kernels.append((e.key, e.count, e.self_device_time_total))
    kernels.sort(key=lambda r: -r[2])
    device_s = sum(r[2] for r in kernels) / 1e6
    prov = art.provenance
    return {"wall_s": wall, "explore_s": prov.explore_s,
            "layout_s": prov.layout_s, "net_slots": prov.route_rounds,
            "stages": stages, "device_s": device_s,
            "busy_share": device_s / wall,
            "top": [{"name": k[:60], "calls": c, "device_ms": us / 1e3}
                    for k, c, us in kernels[:15]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this profile runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import DesignRequest, DesignSession

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"gpu: {card}", flush=True)
    request = DesignRequest(array_size=ARRAY_SIZE)
    t0 = time.perf_counter()
    DesignSession().run(request)
    torch.cuda.synchronize()
    print(f"warm-up request (kernel build included): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prof = profile_request(request)
    print(f"request (profiler on): wall {prof['wall_s']:.3f} s, explore "
          f"{prof['explore_s']:.3f} s, layout {prof['layout_s']:.3f} s, "
          f"{prof['net_slots']} net slots", flush=True)
    for name, st in prof["stages"].items():
        dev = ("not recorded" if st["device_ms"] is None
               else f"{st['device_ms']:.3f} ms")
        print(f"  stage {name:6s} host {st['host_ms']:10.3f} ms, device {dev}")
    print(f"device {prof['device_s']:.3f} s, busy share "
          f"{prof['busy_share']:.3f}", flush=True)
    for row in prof["top"]:
        print(f"  {row['device_ms']:10.3f} ms  {row['calls']:6d}x  {row['name']}")
    print(json.dumps({"card": card, "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
