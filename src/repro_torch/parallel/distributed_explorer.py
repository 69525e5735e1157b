"""Device-mesh design exploration: the session's mesh explore engine.

Counterpart of `repro.parallel.distributed_explorer`.  Two mesh
execution modes behind one entry point (`explore_cells_mesh`), both
engines of `repro_torch.api.session.DesignSession` (a request opts in
with `DesignRequest.islands > 1`; a session with `DesignSession(mesh=
...)`):

  * **sharded cells** (`islands == 1`): the coalesced (array_size x
    seed) cell list is split into one block per mesh position, padded
    by repeating the first cell, and each block is one `nsga2.run_cell`
    call on its position's device with the per-cell `PhiloxDraws` seeds
    of `batched_explorer.sweep_program` (on the card one `nsga2_evolve`
    launch a position).  Every cell has its own generator and its own
    CTA, so per-cell fronts are bit-equal to `batched_explorer
    .explore_cells` for any mesh.

  * **islands** (`islands > 1`): every island evolves its own NSGA-II
    population per cell, with ring migration of Pareto elites between
    rounds: island i's top `n_elite` replace island i+1's bottom
    `n_elite` (mod I).  Islands sit on positions in contiguous blocks of
    k; a position runs its k islands x C cells as one flattened batch of
    k C populations (one `nsga2_evolve` launch a round on the card), and
    migration ranks each block with one `rank_and_crowd` (one `nds_rank`
    launch), shifts the elites down one island inside the block and
    copies the last island's elites to the next position's device.
    Island i's draws are a function of (seed, global island id) only
    (`island_seed`), and migration reads island-local data only, so the
    merged result is bit-identical for any mesh size dividing the island
    count.

A mesh is a tuple of `torch.device` positions held by this one process,
the counterpart of JAX's single-controller `Mesh` over `jax.devices()`:
the session and the service are objects of one process, and a library
call does not get an SPMD launcher.  Positions may repeat:
`("cuda:0", "cuda:0")` is a two-position ring on one card, `("cpu",) *
4` one on the CPU (the reference's forced host device count).  The
blocks are issued position after position from this thread; on several
cards their launches overlap only where nothing in between waits for the
device.

The merged front of an island run is the deduplicated Pareto front of
the union of the island populations (`explorer.pareto_result_from_
population` over the flattened island axis).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import nsga2, pareto
from repro_torch.core.batched_explorer import sweep_program
from repro_torch.core.constants import CAL28, CalibConstants
from repro_torch.device import resolve_device

DEFAULT_MIGRATE_EVERY = 20
# The reference's name of the mesh's one axis.  A mesh here is a tuple of
# device positions with no named axes; the name is kept for callers.
MESH_AXIS = "islands"

_MASK64 = (1 << 64) - 1


def default_mesh(max_devices: int | None = None, device=None) -> tuple:
    """A 1-D mesh: every local CUDA device (optionally capped to the
    first `max_devices`), or the one `device` given with an index or a
    type other than cuda.  With no CUDA device and no device given it
    raises (`repro_torch.device.resolve_device`)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    else:
        devices = (dev,)
    if max_devices is not None:
        if max_devices <= 0:
            raise ValueError("max_devices must be positive")
        devices = devices[:max_devices]
    return devices


def as_mesh(positions) -> tuple:
    """A mesh from any sequence of device names or `torch.device`s, all
    of one device type.  A mesh that mixed the CPU and a card could read
    a migrated block before its non-blocking copy lands (`migrate`), and
    the reference's `Mesh` cannot mix platforms either."""
    mesh = tuple(torch.device(p) for p in positions)
    if not mesh:
        raise ValueError("a mesh needs at least one position")
    types = sorted({d.type for d in mesh})
    if len(types) > 1:
        raise ValueError(f"a mesh takes positions of one device type, not "
                         f"{types}: {mesh}")
    return mesh


def mesh_size(mesh) -> int:
    return len(mesh)


def devices_for_islands(mesh, islands: int) -> int:
    """Positions the island engine will actually use: the largest divisor
    of `islands` that fits the mesh.  A divisor (instead of padding)
    keeps the island->position block map exact, which is what makes the
    result independent of the mesh size."""
    n_dev = mesh_size(mesh)
    return max(d for d in range(1, min(islands, n_dev) + 1)
               if islands % d == 0)


def _round_schedule(generations: int, migrate_every: int) -> tuple[int, ...]:
    """Per-round generation counts: migration fires between rounds, so
    `len(schedule) - 1` migrations happen in total."""
    if migrate_every <= 0:
        raise ValueError("migrate_every must be positive")
    full, rem = divmod(generations, migrate_every)
    gens = [migrate_every] * full + ([rem] if rem else [])
    return tuple(gens) or (generations,)


def _elite_count(pop_size: int) -> int:
    return min(max(2, pop_size // 8), pop_size // 2)


# ----------------------------------------------------------------------
# Island draws
# ----------------------------------------------------------------------
def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def island_seed(seed: int, island: int) -> int:
    """The generator seed of global island `island` of a cell seeded
    `seed`: a function of the two alone, never of the mesh."""
    return _mix64(_mix64(int(seed) & _MASK64) ^ int(island))


class PhiloxIslands:
    """The island engine's production draws: one `torch.Generator` per
    (island, cell) on the island's device (Philox on CUDA), seeded with
    `island_seed` and carried on across rounds.

    Called as `draws(islands, rnd, cells, device)` with the global ids of
    one position's islands, the round (0: `run_cell`; r >= 1: the
    `evolve_from` after migration r), the cell list and the position's
    device; returns a draw source for the k C populations, island-major.
    Tests inject another callable of this shape."""

    def __init__(self):
        self._sources: dict[tuple, nsga2.PhiloxDraws] = {}

    def __call__(self, islands, rnd: int, cells, device):
        key = tuple(islands)
        if rnd == 0:
            self._sources[key] = nsga2.PhiloxDraws(
                [island_seed(sd, i) for i in islands for _, sd in cells],
                device)
        return self._sources[key]


# ----------------------------------------------------------------------
# Migration
# ----------------------------------------------------------------------
def _take_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x (k, C, P, M) rows in `order` (k, C, P) along P."""
    return x.gather(2, order[..., None].expand(x.shape))


def migrate(blocks, *, statics: nsga2.EvolveStatics, n_elite: int):
    """Ring-migrate elites across the island axis.

    `blocks` holds one (genes (k, C, P, 3), objs (k, C, P, 4)) pair per
    position, k islands each, C cells, in ring order.  Each (island,
    cell) population is sorted by (rank, -crowding), ties by position;
    the top `n_elite` rows are the island's emigrants and its bottom
    `n_elite` rows are replaced by the previous island's.  Inside a
    block the elites shift down one island; the last island's elites go
    to the next position's device (a peer copy between cards).  The
    sorted layout depends only on island-local data, so the result is
    identical for every mesh.  Returns the migrated pairs, same shapes."""
    sorted_ = []
    for genes, objs in blocks:
        k, c, p, m = objs.shape
        ranks, crowd = nsga2.rank_and_crowd(objs.reshape(k * c, p, m),
                                            statics)
        order = pareto.lexsort2(-crowd, ranks).reshape(k, c, p)
        sorted_.append((_take_rows(genes, order), _take_rows(objs, order)))
    # every block's immigrants are gathered before any block is written
    recv = []
    for d, (sg, so) in enumerate(sorted_):
        pg, po = sorted_[d - 1]          # the previous position, mod n
        recv.append(tuple(
            torch.cat([prev[-1:, :, :n_elite].to(own.device,
                                                 non_blocking=True),
                       own[:-1, :, :n_elite]], 0)
            for prev, own in ((pg, sg), (po, so))))
    for (sg, so), (recv_g, recv_o) in zip(sorted_, recv):
        sg[:, :, -n_elite:] = recv_g
        so[:, :, -n_elite:] = recv_o
    return sorted_


# ----------------------------------------------------------------------
# Entry point
# ----------------------------------------------------------------------
def _sharded(cells, spaces, mesh, statics, generations):
    """islands == 1: one `run_cell` a position on its block of cells."""
    n_dev = mesh_size(mesh)
    pad = (-len(cells)) % n_dev
    padded = cells + cells[:1] * pad
    spaces = spaces + spaces[:1] * pad
    per = len(padded) // n_dev
    genes, objs = [], []
    for d, dev in enumerate(mesh):
        blk = slice(d * per, (d + 1) * per)
        g, o = sweep_program([sd for _, sd in padded[blk]],
                             nsga2.stack_spaces(spaces[blk]).to(dev),
                             statics=statics, n_gens=generations)
        genes.append(g.cpu())
        objs.append(o.cpu())
    genes_b = torch.cat(genes).numpy()[:len(cells)]
    objs_b = torch.cat(objs).numpy()[:len(cells)]
    return {cell: (genes_b[i], objs_b[i]) for i, cell in enumerate(cells)}


def _islands(cells, spaces, mesh, statics, schedule, n_elite, islands,
             draws):
    """islands > 1: rounds of one `run_cell` / `evolve_from` a position
    on its (k C) batch, with `migrate` between them."""
    n_dev = mesh_size(mesh)
    k, c, p = islands // n_dev, len(cells), statics.pop_size
    ids = [range(d * k, (d + 1) * k) for d in range(n_dev)]
    space = [nsga2.stack_spaces(spaces * k).to(dev) for dev in mesh]
    pops = [nsga2.run_cell(draws(ids[d], 0, cells, dev), space[d],
                           statics=statics, n_gens=schedule[0])
            for d, dev in enumerate(mesh)]
    for r, n_gens in enumerate(schedule[1:], 1):
        pops = migrate([(g.reshape(k, c, p, -1), o.reshape(k, c, p, -1))
                        for g, o in pops], statics=statics, n_elite=n_elite)
        pops = [nsga2.evolve_from(draws(ids[d], r, cells, dev),
                                  g.reshape(k * c, p, -1),
                                  o.reshape(k * c, p, -1), space[d], statics,
                                  n_gens)
                for d, (dev, (g, o)) in enumerate(zip(mesh, pops))]
    # (I, C, P, .) in global island order
    genes_b = torch.cat([g.cpu().reshape(k, c, p, -1) for g, _ in pops])
    objs_b = torch.cat([o.cpu().reshape(k, c, p, -1) for _, o in pops])
    genes_b, objs_b = genes_b.numpy(), objs_b.numpy()
    return {cell: (genes_b[:, i].reshape(-1, genes_b.shape[-1]),
                   objs_b[:, i].reshape(-1, objs_b.shape[-1]))
            for i, cell in enumerate(cells)}


def explore_cells_mesh(cells, *, mesh=None, islands: int = 1,
                       migrate_every: int = DEFAULT_MIGRATE_EVERY,
                       pop_size: int = 256, generations: int = 80,
                       crossover_prob: float = nsga2.DEFAULT_CROSSOVER_PROB,
                       mutation_prob: float = nsga2.DEFAULT_MUTATION_PROB,
                       cal: CalibConstants = CAL28,
                       use_pallas_dominance: bool = False,
                       use_pallas_rank: bool = False, draws=None):
    """Explore an (array_size, seed) cell list over a device mesh.

    Returns `({(array_size, seed): ParetoResult}, facts)`: the same front
    mapping as `batched_explorer.explore_cells` plus a facts dict
    (`mesh_devices`, `islands`, `migration_topology`,
    `migration_rounds`) the session stamps into artifact provenance.
    `mesh` is a sequence of positions (`default_mesh()` when None).

    `islands == 1` shards the cell list (bit-equal per-cell fronts to
    the single-device engine); `islands > 1` runs ring-migrating island
    evolution per cell and merges the union front, its draws from
    `draws` (`PhiloxIslands()` when None; see there for the call).
    Either way the result is independent of the mesh size."""
    from repro_torch.core import explorer  # deferred: explorer wraps core flows

    if islands < 1:
        raise ValueError("islands must be >= 1")
    cells = list(dict.fromkeys((int(s), int(sd)) for s, sd in cells))
    if not cells:
        raise ValueError("explore_cells_mesh needs at least one cell")
    mesh = default_mesh() if mesh is None else as_mesh(mesh)
    statics = nsga2.EvolveStatics(
        pop_size=pop_size, crossover_prob=crossover_prob,
        mutation_prob=mutation_prob,
        use_pallas_dominance=use_pallas_dominance,
        use_pallas_rank=use_pallas_rank)
    spaces = [nsga2.space_operands(nsga2.NSGA2Config(array_size=s, cal=cal))
              for s, _ in cells]

    if islands == 1:
        pops = _sharded(cells, spaces, mesh, statics, generations)
        facts = {"mesh_devices": mesh_size(mesh), "islands": 1,
                 "migration_topology": "sharded", "migration_rounds": 0}
    else:
        n_dev = devices_for_islands(mesh, islands)
        schedule = _round_schedule(generations, migrate_every)
        pops = _islands(cells, spaces, mesh[:n_dev], statics, schedule,
                        _elite_count(pop_size), islands,
                        PhiloxIslands() if draws is None else draws)
        facts = {"mesh_devices": n_dev, "islands": islands,
                 "migration_topology": "ring",
                 "migration_rounds": len(schedule) - 1}

    fronts = {(s, sd): explorer.pareto_result_from_population(
                  s, genes, objs, cal=cal)
              for (s, sd), (genes, objs) in pops.items()}
    return fronts, facts


def pareto_front_of(genes: np.ndarray, objs: np.ndarray):
    """Deduplicated non-dominated subset of a raw (genes, objs) union:
    the test-side distillation of a merged island population."""
    uniq, idx = np.unique(genes, axis=0, return_index=True)
    ou = objs[idx]
    mask = pareto.non_dominated_mask(torch.from_numpy(ou)).numpy()
    return uniq[mask], ou[mask]
