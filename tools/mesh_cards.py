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
   (every card) against `mesh=("cuda:0",)`: rows equal, explore seconds;
4. `moe_fwd_a2a` at one full-width deepseek-v2-lite-16b MoE layer (bf16,
   drawn on card 0, 1 x 2048 tokens, a capacity that drops nothing) on
   1, 2 and 4 positions of card 0 and on 2 and 4 cards (experts copied
   to their card): every result equal to one position's, bit for bit,
   and within rel L2 1e-2 of `moe_fwd_dense_eval`; each timed.

It exits 1 on a mismatch and prints each card's name and power limit.
`python3 tools/mesh_cards.py --train [...]` runs `tools/train_cards.py`
(the mesh train step with one position a card, on four cards) instead,
its arguments after `--train`.
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


def moe_a2a_across_cards(n: int) -> None:
    from repro_torch.configs import registry
    from repro_torch.models import mlp
    from repro_torch.parallel.moe_a2a import moe_fwd_a2a

    cfg = registry.get("deepseek-v2-lite-16b")
    g = torch.Generator(device="cuda:0").manual_seed(0)
    ffn = mlp.init_moe(cfg.d_model, cfg, g).to(torch.bfloat16)
    ffn.requires_grad_(False)
    x = torch.randn((1, 2048, cfg.d_model), generator=g,
                    device="cuda:0").bfloat16()
    want = mlp.moe_fwd_dense_eval(ffn, x, cfg)
    meshes = {f"{k} on cuda:0": ("cuda:0",) * k for k in (1, 2, 4)}
    meshes.update({f"{k} cards": tuple(f"cuda:{i}" for i in range(k))
                   for k in (2, 4) if k <= n})
    first = None
    for name, mesh in meshes.items():
        y = moe_fwd_a2a(ffn, x, cfg, mesh, capacity=2048)
        torch.cuda.synchronize(0)
        t0 = time.perf_counter()
        y = moe_fwd_a2a(ffn, x, cfg, mesh, capacity=2048)
        for d in set(mesh):
            torch.cuda.synchronize(d)
        ms = (time.perf_counter() - t0) * 1e3
        rel = float((y.float() - want.float()).norm() / want.float().norm())
        first = y if first is None else first
        if not torch.equal(y, first) or rel > 1e-2:
            fail(f"moe a2a on {name}: equal to one position's "
                 f"{torch.equal(y, first)}, rel L2 {rel:.3e}")
        print(f"moe a2a ({cfg.name} layer, 1 x 2048) on {name}: {ms:.2f} ms; "
              f"rel L2 vs dense eval {rel:.3e}; equal to one position's",
              flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--train"]:
        import train_cards

        return train_cards.main(sys.argv[2:])
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
    moe_a2a_across_cards(n)
    print("mesh_cards: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
