"""NSGA-II parity: the port's operators, fed the reference's own
`jax.random` draws, reproduce the reference's generations bit for bit;
with its own Philox draws the port recovers the true front.

The port's SNR objective differs from XLA's by a few ulps (`log`), which
would move crowding distances by ulps.  The bit-equality tests therefore
evaluate objectives with the reference's operator (patched into the
port's `evaluate_op`), so they hold the selection, variation, repair,
ranking, crowding and truncation logic exactly; the estimator itself is
held separately (test_torch_estimator.py, rtol 1e-6)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched_explorer as rbatched
from repro.core import explorer as rexplorer
from repro.core import nsga2 as rnsga2
from repro.core import pareto as rpareto
from repro_torch.core import batched_explorer as tbatched
from repro_torch.core import nsga2 as tnsga2
from repro_torch.core import pareto as tpareto
from torch_port_helpers import JaxDraws, port_space

SIZES = (4096, 16384)


@pytest.fixture
def reference_evaluate(monkeypatch):
    """Patch the port's `evaluate_op` to the reference's jitted operator
    on the reference's operands of the same cells."""
    cfgs = [rnsga2.NSGA2Config(array_size=s) for s in SIZES]
    spaces = [rnsga2.space_operands(c) for c in cfgs]
    ev = jax.jit(rnsga2.evaluate_op)

    def evaluate(genes, space):
        g = genes.numpy()
        return torch.from_numpy(np.stack([
            np.asarray(ev(jnp.asarray(g[c]), spaces[c]))
            for c in range(len(g))]))

    monkeypatch.setattr(tnsga2, "evaluate_op", evaluate)


def _statics(pop):
    return (rnsga2.EvolveStatics(pop_size=pop),
            tnsga2.EvolveStatics(pop_size=pop))


def test_generation_step_bit_equal(reference_evaluate):
    pop = 64
    rstat, tstat = _statics(pop)
    cfgs = [rnsga2.NSGA2Config(array_size=s) for s in SIZES]
    rspaces = [rnsga2.space_operands(c) for c in cfgs]
    tspace = port_space(cfgs)
    step = jax.jit(functools.partial(rnsga2.generation_step_op,
                                     statics=rstat))
    state, ref_out, subs = [], [], []
    for c, sp in enumerate(rspaces):
        genes = rnsga2.init_population_op(jax.random.key(10 + c), sp, pop)
        objs = rnsga2.evaluate_op(genes, sp)
        ranks, crowd = rnsga2.rank_and_crowd(objs, rstat)
        sub = jax.random.key(20 + c)
        subs.append(sub)
        state.append((genes, objs, ranks, crowd))
        ref_out.append(step(sub, genes, objs, ranks, crowd, space=sp))
    as_t = lambda i, dt=None: torch.from_numpy(  # noqa: E731
        np.stack([np.asarray(s[i]) for s in state]))
    draws = JaxDraws.step(subs, pop, pop, tstat)
    got = tnsga2.generation_step_op(
        draws, as_t(0), as_t(1), as_t(2), as_t(3), tspace, tstat)
    for i, name in enumerate(("genes", "objs", "ranks", "crowd")):
        want = np.stack([np.asarray(r[i]) for r in ref_out])
        np.testing.assert_array_equal(got[i].numpy(), want, err_msg=name)


def test_run_cell_bit_equal(reference_evaluate):
    pop, gens = 64, 5
    rstat, tstat = _statics(pop)
    cfgs = [rnsga2.NSGA2Config(array_size=s) for s in SIZES]
    keys = [jax.random.key(s) for s in (7, 8)]
    rg, ro = rbatched.sweep_program(
        jnp.stack(keys), rbatched.stack_spaces([rnsga2.space_operands(c)
                                                for c in cfgs]),
        statics=rstat, n_gens=gens)
    tg, to = tnsga2.run_cell(JaxDraws(keys), port_space(cfgs),
                             statics=tstat, n_gens=gens)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(to.numpy(), np.asarray(ro))
    ranks = tpareto.non_dominated_rank(to)
    crowd = tpareto.crowding_distance(to, ranks)
    for c in range(len(cfgs)):
        rr, rc = rnsga2.rank_and_crowd(jnp.asarray(ro[c]), rstat)
        np.testing.assert_array_equal(ranks[c].numpy(), np.asarray(rr))
        np.testing.assert_array_equal(crowd[c].numpy(), np.asarray(rc))


def test_operators_match_reference():
    """repair / decode / init / tournament / variation on raw inputs."""
    cfg = rnsga2.NSGA2Config(array_size=16384)
    rsp, tsp = rnsga2.space_operands(cfg), port_space([cfg])
    bad = np.array([[20, 9, 9], [4, 7, 8], [6, 1, 0], [9, 5, 3]], np.int32)
    np.testing.assert_array_equal(
        tnsga2.repair_op(torch.from_numpy(bad)[None], tsp)[0].numpy(),
        np.asarray(rnsga2.repair_op(jnp.asarray(bad), rsp)))
    draws = JaxDraws([jax.random.key(3)])
    got = tnsga2.init_population_op(
        draws.init(tsp.gene_lo.numpy(), tsp.gene_hi.numpy(), 32), tsp)
    want = rnsga2.init_population_op(jax.random.split(jax.random.key(3))[0],
                                     rsp, 32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    for t, r in zip(tnsga2.decode_op(got, tsp), rnsga2.decode_op(want, rsp)):
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(r))


def test_recovers_true_front_16kb():
    """Mirror of tests/test_pareto_nsga2.py::test_recovers_true_front_16kb
    with the port's own Philox draws."""
    genes, objs = rexplorer.full_design_space(16384)
    true_mask = np.asarray(rpareto.non_dominated_mask(objs))
    true_front = {tuple(g) for g, m in zip(np.asarray(genes), true_mask) if m}
    res = tbatched.explore_cells([(16384, 3)], pop_size=192, generations=60,
                                 device="cpu")[(16384, 3)]
    found = {(int(np.log2(s.h)), int(np.log2(s.l)), s.b_adc)
             for s in res.specs}
    assert found <= true_front
    assert len(found) >= 0.6 * len(true_front)


def test_cell_front_independent_of_batch():
    """Per-cell generators: a cell's front does not depend on the cells
    it was explored with."""
    kw = dict(pop_size=48, generations=8, device="cpu")
    alone = tbatched.explore_cells([(16384, 5)], **kw)[(16384, 5)]
    mixed = tbatched.explore_cells([(4096, 1), (16384, 5), (65536, 2)],
                                   **kw)[(16384, 5)]
    assert alone.specs == mixed.specs
    for k in alone.metrics:
        np.testing.assert_array_equal(alone.metrics[k], mixed.metrics[k])
