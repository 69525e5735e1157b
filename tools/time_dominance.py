"""Time the `dominance_matrix` kernel of the checkout at TREE on the card:

    python3 tools/time_dominance.py TREE

At the composite loop's pools, (cells, points, objectives) = (1, 512, 4)
(the 16 kb request) and (1, 192, 4) (the codesign pick), at (3, 512, 4),
and at (1, 32, 1) (one warp's worth of work: the launch floor), it prints
the mean of 200 back-to-back calls by CUDA events (which includes the
wrapper's host time) and the kernel's own device time from
torch.profiler.  To compare two versions, run it for each tree in one
machine session in turns (A, B, B, A).
"""
import sys

root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels.pareto_dom import kernel as pd  # noqa: E402

dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
out = {}
for shape in ((1, 512, 4), (1, 192, 4), (3, 512, 4), (1, 32, 1)):
    f = torch.randint(0, 4, shape, generator=g, device=dev).float()
    event_ms = c.cuda_ms(lambda: pd.dominance_matrix(f), 200)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            pd.dominance_matrix(f)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "dominance" in e.key)
    out[shape] = (round(event_ms, 5), round(us / 1e3 / 50, 5))
print(f"AB {root}: dominance_matrix (event ms, device ms) {out}", flush=True)
