"""`nsga2_evolve` (every NSGA-II generation of an explore dispatch in one
call) on the CPU: its plain version, fed the reference's own
`jax.random` draws stacked over generations, equals the reference's
`run_cell` bit for bit; it equals the per-generation composite loop;
and a numpy model of the kernel's sort keys (`nsga2_keys_model.py`)
orders points as `pareto.lexsort2` does and gives the composite's
crowding distances.  The kernel itself is held to the composite on the
card (`test_torch_kernels_cuda.py`, `chip_smoke.py`).

As in `test_torch_nsga2.py`, the bit-equality tests against the
reference evaluate objectives with the reference's operator (the
port's SNR differs from XLA's by ulps; the estimator is held separately
to rtol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import batched_explorer as rbatched
from repro.core import nsga2 as rnsga2
from repro_torch.core import nsga2 as tnsga2
from repro_torch.core import pareto as tpareto
from repro_torch.kernels.pareto_dom import kernel as tkernel
from repro_torch.kernels.pareto_dom import ops as tops
from repro_torch.kernels.pareto_dom import ref as tref
import nsga2_keys_model as km
from torch_port_helpers import JaxDraws, port_space

# (pop, generations, cell sizes, key seeds): the explorer's default pop
# and the codesign pick's, 2-3 cells of different sizes each.
CASES = [(256, 4, (16384, 4096), (7, 8)),
         (96, 6, (4096, 16384, 65536), (1, 2, 3))]


@pytest.fixture
def reference_evaluate(monkeypatch):
    """Patch the port's `evaluate_op` to the reference's jitted operator
    on the reference's operands of the same cells (by array size)."""
    ev = jax.jit(rnsga2.evaluate_op)
    spaces = {}

    def evaluate(genes, space):
        out = []
        for c, size in enumerate(space.array_size.tolist()):
            sp = spaces.setdefault(size, rnsga2.space_operands(
                rnsga2.NSGA2Config(array_size=int(size))))
            out.append(np.asarray(ev(jnp.asarray(genes[c].numpy()), sp)))
        return torch.from_numpy(np.stack(out))

    monkeypatch.setattr(tnsga2, "evaluate_op", evaluate)


def _start(draws, space, pop):
    genes = tnsga2.init_population_op(
        draws.init(space.gene_lo.numpy(), space.gene_hi.numpy(), pop), space)
    return genes, tnsga2.evaluate_op(genes, space)


@pytest.mark.parametrize("pop,gens,sizes,seeds", CASES)
def test_plain_evolve_equals_reference_run_cell(reference_evaluate, pop,
                                                gens, sizes, seeds):
    cfgs = [rnsga2.NSGA2Config(array_size=s) for s in sizes]
    keys = [jax.random.key(s) for s in seeds]
    rstat = rnsga2.EvolveStatics(pop_size=pop)
    rg, ro = rbatched.sweep_program(
        jnp.stack(keys), rbatched.stack_spaces([rnsga2.space_operands(c)
                                                for c in cfgs]),
        statics=rstat, n_gens=gens)
    tstat = tnsga2.EvolveStatics(pop_size=pop)
    space = port_space(cfgs)
    draws = JaxDraws(keys)
    genes, objs = _start(draws, space, pop)
    stacked = draws.generations(gens, pop, pop, tstat)
    assert stacked.u.shape == (gens, len(sizes), pop, 3)
    g, o, r = tref.nsga2_evolve_ref(stacked, genes, objs, space, tstat)
    np.testing.assert_array_equal(g.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(o.numpy(), np.asarray(ro))
    for c in range(len(cfgs)):
        rr, _ = rnsga2.rank_and_crowd(jnp.asarray(ro[c]), rstat)
        np.testing.assert_array_equal(r[c].numpy(), np.asarray(rr))


@pytest.mark.parametrize("pop,gens,sizes,seeds", CASES)
def test_plain_evolve_equals_per_generation_composite(pop, gens, sizes,
                                                      seeds):
    """Draws made at once (`PhiloxDraws.generations`) give what the
    composite loop gives drawing one generation at a time, so production
    fronts are what they were; `run_cell` routes through `nsga2_evolve`."""
    cfgs = [tnsga2.NSGA2Config(array_size=s) for s in sizes]
    space = tnsga2.stack_spaces([tnsga2.space_operands(c) for c in cfgs])
    statics = tnsga2.EvolveStatics(pop_size=pop)
    genes, objs = _start(tnsga2.PhiloxDraws(seeds, "cpu"), space, pop)
    want = tnsga2.evolve_composite(tnsga2.PhiloxDraws(seeds, "cpu"), genes,
                                   objs, space, statics, gens)
    stacked = tnsga2.PhiloxDraws(seeds, "cpu").generations(gens, pop, pop,
                                                           statics)
    got = tops.nsga2_evolve(stacked, genes, objs, space, statics)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    # run_cell draws its initial population first, then the generations
    rg, ro = tnsga2.run_cell(tnsga2.PhiloxDraws(seeds, "cpu"), space,
                             statics=statics, n_gens=gens)
    d = tnsga2.PhiloxDraws(seeds, "cpu")
    g0, o0 = _start(d, space, pop)
    wg, wo, _ = tnsga2.evolve_composite(d, g0, o0, space, statics, gens)
    assert torch.equal(rg, wg) and torch.equal(ro, wo)


def test_zero_generations_and_wrapper_checks():
    space = tnsga2.stack_spaces([tnsga2.space_operands(
        tnsga2.NSGA2Config(array_size=16384))])
    statics = tnsga2.EvolveStatics(pop_size=32)
    draws = tnsga2.PhiloxDraws([0], "cpu")
    genes, objs = _start(draws, space, 32)
    stacked = draws.generations(0, 32, 32, statics)
    g, o, r = tops.nsga2_evolve(stacked, genes, objs, space, statics)
    assert torch.equal(g, genes) and torch.equal(o, objs)
    assert torch.equal(r, tpareto.non_dominated_rank(objs))
    stacked = draws.generations(2, 32, 32, statics)
    with pytest.raises(ValueError, match="card"):
        tkernel.nsga2_evolve(stacked, genes, objs, space, statics,
                             fronts=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="pop_size"):
        tkernel.nsga2_evolve(stacked, genes, objs, space,
                             tnsga2.EvolveStatics(pop_size=16))
    with pytest.raises(ValueError, match="genes"):
        tkernel.nsga2_evolve(stacked, genes.long(), objs, space, statics)
    with pytest.raises(ValueError, match="draws.u"):
        tkernel.nsga2_evolve(stacked._replace(u=stacked.u[:, :, :16]),
                             genes, objs, space, statics)


def test_evolve_operands_pack_the_draws():
    """The kernel's flags byte: bit k = crossover and swap of gene k, bit
    3 + k = mutate gene k; pairs as int32; cal and bounds per cell."""
    sizes = (4096, 65536)
    space = tnsga2.stack_spaces([tnsga2.space_operands(
        tnsga2.NSGA2Config(array_size=s)) for s in sizes])
    statics = tnsga2.EvolveStatics(pop_size=40)
    d = tnsga2.PhiloxDraws([3, 4], "cpu").generations(3, 40, 40, statics)
    pairs, flags, u, cal, bounds = tkernel.evolve_operands(d, space, 40)
    assert pairs.dtype == torch.int32 and torch.equal(pairs.long(), d.pairs)
    f = flags.long()
    for k in range(3):
        assert torch.equal(((f >> k) & 1).bool(), (d.do_cx & d.swap)[..., k])
        assert torch.equal(((f >> (3 + k)) & 1).bool(), d.mut[..., k])
    assert torch.equal(u, d.u)
    assert cal.shape == (2, 15) and torch.equal(cal[:, 0], space.array_size)
    assert torch.equal(cal[:, -1], space.cal.a_dff)
    assert torch.equal(bounds, torch.cat([space.gene_lo, space.gene_hi], -1))


# ----------------------------------------------------------------------
# The kernel's sort keys
# ----------------------------------------------------------------------
def _lexsort2(secondary, primary) -> np.ndarray:
    return tpareto.lexsort2(torch.from_numpy(np.asarray(secondary)),
                            torch.from_numpy(np.asarray(primary))).numpy()


def test_ord_key_is_order_preserving_with_signed_zeros():
    x = np.array([-np.inf, -1e30, -3.5, -1e-45, -0.0, 0.0, 1e-45, 2.0, 1e30,
                  4e30, np.inf], np.float32)
    k = km.ord_key(x)
    assert (np.diff(k.astype(np.int64)) >= 0).all()
    assert k[4] == k[5]                              # -0.0 == +0.0
    assert (np.diff(np.delete(k, 4).astype(np.int64)) > 0).all()


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 300), n_ranks=st.integers(1, 6),
       seed=st.integers(0, 2 ** 31 - 1))
def test_key_order_equals_lexsort2(n, n_ranks, seed):
    """Ties, -0.0 against 0.0, 1e30 sums of boundary distances and
    duplicated points, in crowding's (value, rank) sort and selection's
    (-crowding, rank) sort."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(0, n_ranks, n)
    pool = np.array([0.0, -0.0, 1.0, -1.0, 1e30, 2e30, 3e30, 4e30, 0.5,
                     -2.5, 1e-12], np.float32)
    v = np.where(rng.random(n) < 0.6, rng.choice(pool, n),
                 rng.normal(size=n)).astype(np.float32)
    dup = rng.integers(0, n, n // 3)
    v[rng.integers(0, n, n // 3)] = v[dup]
    np.testing.assert_array_equal(km.key_order(ranks, v), _lexsort2(v, ranks))
    np.testing.assert_array_equal(km.selection_order(ranks, v),
                                  _lexsort2(-v, ranks))


@settings(max_examples=40, deadline=None)
@given(n=st.integers(2, 120), n_dup=st.integers(0, 40),
       seed=st.integers(0, 2 ** 31 - 1))
def test_keys_model_crowding_equals_composite(n, n_dup, seed):
    """The kernel's crowding (fronts from the sorted keys, fmin / fmax at a
    front's ends) equals `pareto.crowding_distance`, duplicates and all."""
    rng = np.random.default_rng(seed)
    f = rng.integers(-3, 4, (n, 4)).astype(np.float32)
    f[:, 1] *= np.float32(0.0)                       # signed zeros
    f[:, 3] = rng.normal(size=n)
    if n_dup:
        f[rng.integers(0, n, n_dup)] = f[rng.integers(0, n, n_dup)]
    ranks = tpareto.non_dominated_rank(torch.from_numpy(f))
    want = tpareto.crowding_distance(torch.from_numpy(f), ranks).numpy()
    got = km.crowding(f, ranks.numpy())
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(km.selection_order(ranks.numpy(), got),
                                  _lexsort2(-want, ranks.numpy()))
