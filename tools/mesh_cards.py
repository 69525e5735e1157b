"""The port's kernels on cards other than the current device, and the
island ring across cards, on a machine with two or more CUDA devices:

    python3 tools/mesh_cards.py

1. `DesignSession(device=f"cuda:{i}").run(DesignRequest(16384))` on each
   card: the content (front and layout rows) must equal card 0's, with
   one `nsga2_evolve` and one `route_slots` launch, and the thread's
   current device must be left as it was;
2. 8 islands of pop 96 x 60 generations migrating every 10 on the 16 kb
   cell (the reference's device-independence run) on meshes of 1, 2 and
   4 positions, first all on card 0, then one position a card: the rows
   must be equal everywhere; each mesh is timed, three rounds in turns,
   and the median printed beside the device count;
3. `DesignRequest(16384, islands=4)` through `DesignSession(mesh=True)`
   (every card) against `mesh=("cuda:0",)`: rows equal, explore seconds.

It exits 1 on a mismatch and prints each card's name and power limit.
"""
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402

from repro_torch.api import DesignRequest, DesignSession  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.parallel import distributed_explorer as dx  # noqa: E402

ISLANDS = dict(islands=8, migrate_every=10, pop_size=96, generations=60)
CELL = (16384, 0)
ROUNDS = 3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> int:
    n = torch.cuda.device_count()
    if n < 2:
        fail(f"needs two or more CUDA devices, found {n}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    req = DesignRequest(array_size=CELL[0])
    want = DesignSession(device="cuda:0").run(req)
    for i in range(n):
        before = torch.cuda.current_device()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        got = DesignSession(device=f"cuda:{i}").run(req)
        torch.cuda.synchronize(i)
        dt = time.perf_counter() - t0
        launches = (LAUNCHES["nsga2_evolve"], LAUNCHES["route_slots"])
        if got.summary() != want.summary() or launches != (1, 1) \
                or torch.cuda.current_device() != before:
            fail(f"session on cuda:{i}: launches {launches}, current device "
                 f"{torch.cuda.current_device()}, content equal "
                 f"{got.summary() == want.summary()}")
        print(f"session on cuda:{i}: {len(got.layout_rows)} rows equal to "
              f"cuda:0's, launches {launches}, {dt:.3f} s", flush=True)

    meshes = {}
    for k in (1, 2, 4):
        meshes[f"{k} on cuda:0"] = ("cuda:0",) * k
        if 1 < k <= n:
            meshes[f"{k} cards"] = tuple(f"cuda:{i}" for i in range(k))
    rows, times = {}, {m: [] for m in meshes}
    for _ in range(ROUNDS):
        for name, mesh in meshes.items():
            t0 = time.perf_counter()
            res, facts = dx.explore_cells_mesh([CELL], mesh=mesh, **ISLANDS)
            for d in set(mesh):
                torch.cuda.synchronize(d)
            times[name].append((time.perf_counter() - t0) * 1e3)
            rows[name] = res[CELL].to_rows()
    first = next(iter(rows.values()))
    bad = [m for m, r in rows.items() if r != first]
    if bad:
        fail(f"islands: rows differ on {bad}")
    for name in meshes:
        print(f"islands {ISLANDS} on {name}: median "
              f"{statistics.median(times[name]):.2f} ms of "
              f"{[round(t, 2) for t in times[name]]}; rows equal",
              flush=True)

    isl = DesignRequest(array_size=CELL[0], islands=4)
    one = DesignSession(mesh=("cuda:0",)).run(isl)
    every = DesignSession(mesh=True).run(isl)
    if one.summary() != every.summary():
        fail("island request: rows differ between one card and every card")
    print(f"island request (islands 4): explore {one.provenance.explore_s:.3f}"
          f" s on cuda:0, {every.provenance.explore_s:.3f} s on {n} cards "
          f"({every.provenance.mesh_devices} positions); rows equal",
          flush=True)
    print("mesh_cards: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
