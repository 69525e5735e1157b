"""Time the 16 kb request's exploration (array size 16384, seed 0, pop 256,
80 generations) for the checkout at TREE (its own `src`), on the card:

    python3 tools/time_explore.py TREE

It prints, after a warm-up, five host-clock seconds (each ending in a
device synchronize) of `batched_explorer.explore_cells` as TREE routes it
and, where TREE has `nsga2.evolve_composite`, five of the same
exploration run by that composite loop (torch operators and one
`nds_rank` launch a generation) and three means of 20 launches of the
`nsga2_evolve` kernel on the dispatch's inputs (CUDA events); then five
of the whole request, `DesignSession().run(DesignRequest(16384))` on a
fresh session.  Host-bound
times vary between calls, so compare two trees in one machine session,
in turns (A, B, B, A).
"""
import sys
import time

root = sys.argv[1]
sys.path[:0] = [root + "/src"]
import torch  # noqa: E402

from repro_torch.api import DesignRequest, DesignSession  # noqa: E402
from repro_torch.core import batched_explorer, nsga2  # noqa: E402

SIZE, SEED, POP, GENS, REPS = 16384, 0, 256, 80, 5


def seconds(fn) -> list[float]:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def composite(seeds, spaces):
    statics = nsga2.EvolveStatics(pop_size=POP)
    draws = nsga2.PhiloxDraws(seeds, spaces.gene_lo.device)
    genes = nsga2.init_population_op(draws.init(
        spaces.gene_lo.cpu().numpy(), spaces.gene_hi.cpu().numpy(),
        POP).to(spaces.gene_lo.device), spaces)
    objs = nsga2.evaluate_op(genes, spaces)
    return nsga2.evolve_composite(draws, genes, objs, spaces, statics,
                                  GENS)[:2]


cells = [(SIZE, SEED)]
times = {"explore": seconds(lambda: batched_explorer.explore_cells(
    cells, pop_size=POP, generations=GENS))}
if hasattr(nsga2, "evolve_composite"):
    times["composite explore"] = seconds(
        lambda: batched_explorer.explore_cells(cells, program=composite))
if hasattr(nsga2, "evolve_composite"):
    from repro_torch.kernels.pareto_dom import ops

    space = nsga2.stack_spaces([nsga2.space_operands(
        nsga2.NSGA2Config(array_size=SIZE))]).to("cuda")
    statics = nsga2.EvolveStatics(pop_size=POP)
    draws = nsga2.PhiloxDraws([SEED], "cuda")
    genes = nsga2.init_population_op(draws.init(
        space.gene_lo.cpu().numpy(), space.gene_hi.cpu().numpy(),
        POP).to("cuda"), space)
    objs = nsga2.evaluate_op(genes, space)
    stacked = draws.generations(GENS, POP, POP, statics)
    kernel_ms = []
    for _ in range(3):
        ops.nsga2_evolve(stacked, genes, objs, space, statics)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(20):
            ops.nsga2_evolve(stacked, genes, objs, space, statics)
        end.record()
        torch.cuda.synchronize()
        kernel_ms.append(start.elapsed_time(end) / 20)
    print(f"AB {root}: nsga2_evolve kernel ms {kernel_ms}", flush=True)
times["request"] = seconds(lambda: DesignSession().run(DesignRequest(SIZE)))
for what, s in times.items():
    print(f"AB {root}: {what} s {s}", flush=True)
