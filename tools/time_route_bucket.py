"""Time the `route_slots` launch of the 16 kb request's layout bucket for
the checkout at TREE (its own `src` and `chip_smoke.py`), on the card:

    python3 tools/time_route_bucket.py TREE

It prints three means of 10 launches each.  To compare two versions, run
it in one machine session for each tree in turns (A, B, B, A).
"""
import sys

root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.core.acim_spec import MacroSpec  # noqa: E402
from repro_torch.kernels.maze_route import kernel as mr  # noqa: E402

specs = [MacroSpec(p["row"]["h"], p["row"]["w"], p["row"]["l"],
                   p["row"]["b_adc"]) for p in c.golden_points()]
dev = torch.device("cuda")
occ0, nets, grids_t, _ = c.request_bucket(specs, dev)
ms = [c.cuda_ms(lambda: mr.route_slots(occ0, *nets, grids_t, c.CAPACITY), 10)
      for _ in range(3)]
print(f"AB {root}: route_slots whole 16 kb bucket ms {ms}", flush=True)
