"""The port's device-mesh explorer (`repro_torch.parallel
.distributed_explorer`) held against the reference's on the CPU.

A mesh in the port is a tuple of device positions in one process;
`("cpu",) * n` stands for the reference's n forced host devices.

- Sharded cells: per-cell fronts bit-equal to the port's single-device
  `explore_cells` on 1, 2 and 3 positions (3 cells on 2 positions pad).
- Islands: fed draws made with `jax.random` under the reference's keys
  (island i of a cell: `fold_in(key(seed), i)`; the evolve round after
  migration r: `fold_in(that, 0x5EED0000 + r)`), the port on 1, 2 and 4
  positions against the reference's `explore_cells_mesh` on its one CPU
  device: final genes bit-equal, fronts equal as sets, facts equal.
  Objectives: XLA's fused estimator inside the reference's jitted
  program differs from its own eager form by up to 2.4e-6 relative (one
  SNR value at 16384), which the port's estimator follows; so the run
  whose objectives are held to the reference's at rtol 1e-6 evaluates
  them with the reference's jitted operator patched into the port (as
  `test_torch_nsga2.py` does), and the unpatched run holds the port's
  objectives to the reference's estimator on the same final genes at
  rtol 1e-6.
- `migrate` alone against the reference's, on a hand-made population
  with ties in rank and crowding (the reference's island program with
  its `run_cell` replaced by a table of that population).
- With the port's own Philox draws: the same front on 1, 2 and 4
  positions; the session and the service route island requests to the
  mesh engine and stamp its facts into provenance; an island artifact
  served from the artifact cache is re-stamped as the reference's
  session re-stamps it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import artifact_cache as rcache
from repro.api import request as rrequest
from repro.api import session as rsession
from repro.core import explorer as rexplorer
from repro.core import nsga2 as rnsga2
from repro.parallel import distributed_explorer as rdx
from repro_torch.api import DesignRequest, DesignSession, Requirements
from repro_torch.core import explorer as texplorer
from repro_torch.core import nsga2 as tnsga2
from repro_torch.core.batched_explorer import explore_cells
from repro_torch.parallel import distributed_explorer as dx
from repro_torch.serve.design_service import DesignService
from torch_port_helpers import JaxDraws

pytestmark = pytest.mark.timeout(300)

CELLS = [(4096, 0), (16384, 1)]
ISLANDS = dict(islands=4, migrate_every=5, pop_size=40, generations=20)
# one to three specs of a 4096 front: quick plain routing on the CPU
LAID = Requirements(min_snr_db=25.0, min_tops=0.3)


def jax_island_draws(islands, rnd, cells, device):
    """The reference's island keys as an injected draw source."""
    keys = [jax.random.fold_in(jax.random.key(sd), i)
            for i in islands for _, sd in cells]
    if rnd == 0:
        return JaxDraws(keys)
    return JaxDraws.from_generation_keys(
        [jax.random.fold_in(k, 0x5EED0000 + rnd - 1) for k in keys])


def _capture(monkeypatch, module):
    """Record the (genes, objs) each cell's population hands to
    `pareto_result_from_population`, by array size."""
    seen = {}
    orig = module.pareto_result_from_population

    def capture(array_size, genes, objs, cal):
        seen[array_size] = (np.asarray(genes), np.asarray(objs))
        return orig(array_size, genes, objs, cal=cal)

    monkeypatch.setattr(module, "pareto_result_from_population", capture)
    return seen


def _specs(res) -> set:
    return {s.as_tuple() for s in res.specs}


def _one_device_mesh():
    """The reference's 1-device mesh.  A test worker may hold more host
    devices (other test files force host device counts before JAX
    starts), and the reference's result does not depend on the count."""
    return rdx.default_mesh(max_devices=1)


@pytest.fixture(scope="module")
def reference_islands():
    """The reference's island run on one CPU device: (fronts, facts,
    {array_size: final (genes, objs)})."""
    with pytest.MonkeyPatch.context() as mp:
        seen = _capture(mp, rexplorer)
        fronts, facts = rdx.explore_cells_mesh(CELLS, mesh=_one_device_mesh(),
                                               **ISLANDS)
    return fronts, facts, seen


def _reference_evaluate(monkeypatch):
    """Patch the port's `evaluate_op` to the reference's jitted operator,
    each population on the reference's operands of its array size."""
    ev = jax.jit(rnsga2.evaluate_op)
    spaces = {}

    def evaluate(genes, space):
        out = []
        for g, s in zip(genes.numpy(), space.array_size.tolist()):
            sp = spaces.setdefault(int(s), rnsga2.space_operands(
                rnsga2.NSGA2Config(array_size=int(s))))
            out.append(np.asarray(ev(jnp.asarray(g), sp)))
        return torch.from_numpy(np.stack(out))

    monkeypatch.setattr(tnsga2, "evaluate_op", evaluate)


# -- sharded cells --------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_cells_bit_equal_to_explore_cells(n):
    cells = CELLS + [(65536, 0)]
    want = explore_cells(cells, pop_size=32, generations=6, device="cpu")
    got, facts = dx.explore_cells_mesh(cells, mesh=("cpu",) * n,
                                       pop_size=32, generations=6)
    assert facts == {"mesh_devices": n, "islands": 1,
                     "migration_topology": "sharded", "migration_rounds": 0}
    assert set(got) == set(want)
    for cell in cells:
        assert got[cell].to_rows() == want[cell].to_rows(), cell


# -- islands against the reference ----------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
def test_islands_match_reference(n, reference_islands, monkeypatch):
    """Objectives by the reference's operator: genes bit-equal,
    objectives to rtol 1e-6, fronts as sets, facts."""
    rfronts, rfacts, rseen = reference_islands
    _reference_evaluate(monkeypatch)
    seen = _capture(monkeypatch, texplorer)
    fronts, facts = dx.explore_cells_mesh(CELLS, mesh=("cpu",) * n,
                                          draws=jax_island_draws, **ISLANDS)
    assert facts == {**rfacts, "mesh_devices": n}
    assert rfacts == {"mesh_devices": 1, "islands": 4,
                      "migration_topology": "ring", "migration_rounds": 3}
    for size, sd in CELLS:
        (rg, ro), (g, o) = rseen[size], seen[size]
        assert g.shape == (ISLANDS["islands"] * ISLANDS["pop_size"], 3)
        np.testing.assert_array_equal(g, rg)
        np.testing.assert_allclose(o, ro, rtol=1e-6)
        assert _specs(fronts[(size, sd)]) == _specs(rfronts[(size, sd)])


def test_islands_port_estimator_match_reference(reference_islands,
                                                monkeypatch):
    """The port's own estimator end to end: genes still bit-equal and
    fronts equal as sets; its objectives within rtol 1e-6 of the
    reference's estimator on the same genes."""
    rfronts, _, rseen = reference_islands
    seen = _capture(monkeypatch, texplorer)
    fronts, _ = dx.explore_cells_mesh(CELLS, mesh=("cpu",) * 2,
                                      draws=jax_island_draws, **ISLANDS)
    for size, sd in CELLS:
        g, o = seen[size]
        np.testing.assert_array_equal(g, rseen[size][0])
        want = rnsga2.evaluate_op(jnp.asarray(g), rnsga2.space_operands(
            rnsga2.NSGA2Config(array_size=size)))
        np.testing.assert_allclose(o, np.asarray(want), rtol=1e-6)
        assert _specs(fronts[(size, sd)]) == _specs(rfronts[(size, sd)])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_migrate_matches_reference(n, monkeypatch):
    islands, c, p, n_elite = 4, 2, 16, 3
    rng = np.random.default_rng(7)
    objs = rng.integers(0, 3, (islands, c, p, 4)).astype(np.float32)
    objs[:, :, 8:11] = objs[:, :, :3]        # duplicates: equal crowding
    objs[1] = objs[0]                        # whole islands alike
    genes = np.arange(islands * c * p * 3, dtype=np.int32).reshape(
        islands, c, p, 3)
    table_g = jnp.asarray(genes.reshape(islands * c, p, 3))
    table_o = jnp.asarray(objs.reshape(islands * c, p, 4))

    def run_cell(key, space, *, statics, n_gens):
        row = jax.random.key_data(key)[-1]   # key(j) -> population j
        return table_g[row], table_o[row]

    monkeypatch.setattr(rnsga2, "run_cell", run_cell)
    monkeypatch.setattr(rdx, "_PROGRAMS", {})
    statics = rnsga2.EvolveStatics(pop_size=p)
    prog = rdx._island_program(_one_device_mesh(), statics, (0, 0), n_elite)
    keys = jnp.stack([jax.random.key(j) for j in range(islands * c)])
    spaces = [rnsga2.space_operands(rnsga2.NSGA2Config(array_size=s))
              for s, _ in CELLS]
    rg, ro = prog(keys.reshape(islands, c), keys.reshape(1, islands, c),
                  jax.tree.map(lambda *xs: jnp.stack(xs), *spaces))

    k = islands // n
    blocks = [(torch.from_numpy(genes[d * k:(d + 1) * k]),
               torch.from_numpy(objs[d * k:(d + 1) * k])) for d in range(n)]
    out = dx.migrate(blocks, statics=tnsga2.EvolveStatics(pop_size=p),
                     n_elite=n_elite)
    got = torch.cat([g for g, _ in out]).numpy()
    np.testing.assert_array_equal(got, np.asarray(rg))
    # each island's bottom rows are the previous island's (ring) tags
    home = got[..., 0] // (c * p * 3)
    for i in range(islands):
        assert (home[i, :, -n_elite:] == (i - 1) % islands).all()
        assert (home[i, :, :-n_elite] == i).all()
    np.testing.assert_array_equal(torch.cat([o for _, o in out]).numpy(),
                                  np.asarray(ro))


# -- the port's own draws ------------------------------------------------

def test_philox_islands_independent_of_mesh():
    rows = None
    for n in (1, 2, 4):
        fronts, facts = dx.explore_cells_mesh(CELLS, mesh=("cpu",) * n,
                                              **ISLANDS)
        assert facts["mesh_devices"] == n
        got = {c: fronts[c].to_rows() for c in CELLS}
        assert rows is None or got == rows, n
        rows = got
    # the islands draw other streams than the single-population cell
    one = explore_cells(CELLS, pop_size=40, generations=20, device="cpu")
    assert dx.island_seed(0, 0) != 0
    assert any(len(rows[c]) != len(one[c].to_rows()) or
               rows[c] != one[c].to_rows() for c in CELLS)


def test_schedule_divisors_and_seeds_match_reference(monkeypatch):
    for gens in (1, 5, 19, 20, 50, 80):
        for every in (1, 3, 10, 20, 100):
            assert dx._round_schedule(gens, every) == \
                rdx._round_schedule(gens, every)
    with pytest.raises(ValueError):
        dx._round_schedule(10, 0)
    for n_dev in range(1, 9):
        monkeypatch.setattr(rdx, "mesh_size", lambda _, n=n_dev: n)
        for islands in range(1, 17):
            assert dx.devices_for_islands(("cpu",) * n_dev, islands) == \
                rdx.devices_for_islands(None, islands), (n_dev, islands)
    for pop in (8, 16, 40, 96, 256):
        assert dx._elite_count(pop) == rdx._elite_count(pop)
    seeds = {dx.island_seed(s, i) for s in range(64) for i in range(64)}
    assert len(seeds) == 64 * 64
    with pytest.raises(ValueError):
        dx.explore_cells_mesh(CELLS[:1], mesh=("cpu",), islands=0)
    assert dx.default_mesh(device="cpu") == (torch.device("cpu"),)
    assert dx.default_mesh(max_devices=1, device="cpu") == \
        (torch.device("cpu"),)


def test_pareto_front_of_matches_reference():
    genes, objs = rexplorer.full_design_space(4096)
    genes, objs = np.asarray(genes), np.asarray(objs)
    rng = np.random.default_rng(3)
    pick = rng.integers(0, len(genes), 300)
    want = rdx.pareto_front_of(genes[pick], objs[pick])
    got = dx.pareto_front_of(genes[pick], objs[pick])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- session and service -------------------------------------------------

def _island_request(**kw):
    kw.setdefault("islands", 2)
    return DesignRequest(array_size=4096, seed=0, migrate_every=5,
                         pop_size=32, generations=10, requirements=LAID,
                         **kw)


def test_session_runs_island_request(tmp_path):
    req = _island_request()
    session = DesignSession(device="cpu")
    art = session.run(req)
    assert art.ok and art.layout_rows
    prov = art.provenance
    assert (prov.mesh_devices, prov.islands, prov.migration_topology,
            prov.migration_rounds) == (1, 2, "ring", 1)
    assert session.stats["mesh_dispatches"] == 1
    assert session.stats["explorer_dispatches"] == 1
    fronts, _ = dx.explore_cells_mesh([req.cell], mesh=("cpu",), islands=2,
                                      migrate_every=5, pop_size=32,
                                      generations=10)
    want = fronts[req.cell].filter(**LAID.as_filter_kwargs())
    assert art.pareto.to_rows() == want.to_rows()
    path = tmp_path / "island.json"
    art.to_json(path)
    ref = rsession.DesignArtifact.from_json(path)
    assert ref.provenance.islands == 2
    assert ref.provenance.migration_topology == "ring"
    assert ref.pareto.to_rows() == art.pareto.to_rows()
    # a repeat is served from the front cache: no second dispatch
    session.run(req)
    assert session.stats["mesh_dispatches"] == 1


def test_island_artifact_restamped_as_reference(tmp_path):
    """An island artifact in the artifact cache is served by a fresh port
    session and by the reference's session with the same re-stamped
    provenance: islands kept, the mesh fields of a dispatch zeroed."""
    req = _island_request(layout=False)
    first = DesignSession(device="cpu", artifact_cache=tmp_path).run(req)
    assert first.provenance.migration_topology == "ring"
    port = DesignSession(device="cpu", artifact_cache=tmp_path)
    got = port.run(req).provenance
    assert port.stats["mesh_dispatches"] == 0
    ref = rsession.DesignSession(artifact_cache=rcache.ArtifactCache(
        tmp_path)).run(rrequest.DesignRequest.from_dict(req.to_dict()))
    want = dataclasses.asdict(ref.provenance)
    got = dataclasses.asdict(got)
    assert got.pop("total_s") >= 0 and want.pop("total_s") >= 0
    assert got == want
    assert (got["served_from"], got["islands"], got["mesh_devices"],
            got["migration_topology"]) == ("artifact_cache", 2, 0, "")


def test_session_mesh_shards_plain_requests():
    req = DesignRequest(array_size=4096, seed=1, pop_size=32, generations=6,
                        layout=False)
    plain = DesignSession(device="cpu").run(req)
    meshed = DesignSession(device="cpu", mesh=("cpu", "cpu")).run(req)
    assert meshed.summary() == plain.summary()
    assert (meshed.provenance.mesh_devices,
            meshed.provenance.migration_topology) == (2, "sharded")
    assert plain.provenance.migration_topology == ""


def test_service_mesh_counts_dispatches():
    svc = DesignService(mesh=("cpu", "cpu"), device="cpu",
                        max_coalesce=4, coalesce_window_s=0.05)
    reqs = [_island_request(layout=False),
            _island_request(islands=4, layout=False),
            DesignRequest(array_size=4096, seed=1, pop_size=32,
                          generations=6, layout=False)]
    with svc.serve():
        arts = [svc.collect(t, timeout=120)
                for t in [svc.submit(r) for r in reqs]]
    assert all(a.ok for a in arts)
    facts = [(a.provenance.mesh_devices, a.provenance.islands,
              a.provenance.migration_topology) for a in arts]
    assert facts == [(2, 2, "ring"), (2, 4, "ring"), (2, 1, "sharded")]
    mesh_total = svc.metrics()["metrics"]["design_mesh_dispatches_total"]
    assert mesh_total[0]["value"] == svc.stats()["mesh_dispatches"] == 3
    session = DesignSession(device="cpu")
    for r, a in zip(reqs, arts):
        assert a.summary() == session.run(r).summary()
