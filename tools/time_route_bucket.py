"""Time the `route_slots` launch of the 16 kb request's layout bucket for
the checkout at TREE (its own `src` and `chip_smoke.py`), on the card:

    python3 tools/time_route_bucket.py TREE

It prints three means of 10 launches each for the whole front as one
bucket (what `DesignSession.run` lays out), then the same for each of the
buckets the multi-tenant path forms from that front (`run_many` and the
`DesignService`: specs grouped by their routing grid quantized to powers
of two), each with its padded (grids, H, W) and the MB of the int32
congestion map `batched_route` copies back.  To compare two versions,
run it in one machine session for each tree in turns (A, B, B, A).
"""
import sys

root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.api.session import _bucket_key  # noqa: E402
from repro_torch.core.acim_spec import MacroSpec  # noqa: E402
from repro_torch.kernels.maze_route import kernel as mr  # noqa: E402

specs = [MacroSpec(p["row"]["h"], p["row"]["w"], p["row"]["l"],
                   p["row"]["b_adc"]) for p in c.golden_points()]
dev = torch.device("cuda")


def bucket_ms(bucket) -> str:
    occ0, nets, grids_t, _ = c.request_bucket(bucket, dev)
    ms = [round(c.cuda_ms(lambda: mr.route_slots(occ0, *nets, grids_t,
                                                 c.CAPACITY), 10), 4)
          for _ in range(3)]
    return (f"{tuple(occ0.shape)} occ {occ0.numel() * 4 / 1e6:.3f} MB: "
            f"ms {ms}")


print(f"AB {root}: route_slots whole 16 kb bucket {bucket_ms(specs)}",
      flush=True)
buckets: dict = {}
for s in specs:
    buckets.setdefault(_bucket_key(s, c.COARSE, c.CAPACITY), []).append(s)
for key, members in buckets.items():
    print(f"AB {root}: route_slots service bucket {key[2:]} "
          f"({len(members)} specs) {bucket_ms(members)}", flush=True)
