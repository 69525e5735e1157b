"""The explorer's public API in the port (ROADMAP item 7) held against
the JAX reference's functions of the same names, on the CPU.

The deprecated shims (`explore`, `explore_sizes`, `distill_and_layout`)
warn with `repro_torch` in the text; their fronts equal the reference's
and the exhaustive `full_design_space` front as sets, and their layout
rows equal the reference's.  The config-static NSGA-II forms take the
reference's own `jax.random` draws (made in the test under its key
splits) and give bit-equal genes; objectives are evaluated with the
reference's operator patched in (see `test_torch_nsga2.py` for why) and
held at rtol 1e-6 where the port's own estimator computes them.  Last,
an AST diff of the public top-level names of every module the two
packages share finds nothing but the names ROADMAP excludes.
"""
import ast
import pathlib
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched_explorer as rbatched
from repro.core import estimator as restimator
from repro.core import explorer as rexplorer
from repro.core import nsga2 as rnsga2
from repro.core import pareto as rpareto
from repro.kernels.maze_route import ref as rmaze
from repro.kernels.pareto_dom import ops as rdom
from repro.parallel import distributed_explorer as rdist
from repro_torch import api
from repro_torch.core import batched_explorer as tbatched
from repro_torch.core import estimator as testimator
from repro_torch.core import explorer as texplorer
from repro_torch.core import nsga2 as tnsga2
from repro_torch.kernels.maze_route import ref as tmaze
from repro_torch.kernels.pareto_dom import ops as tdom
from repro_torch.parallel import distributed_explorer as tdist
from torch_port_helpers import JaxDraws

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
SIZES = (4096, 16384, 65536)
DISTILL = dict(min_tops=1.4, min_snr_db=20.0)


def _key(res) -> set:
    return {(int(np.log2(s.h)), int(np.log2(s.l)), s.b_adc)
            for s in res.specs}


def _spec_tuples(res) -> list:
    return [(s.h, s.w, s.l, s.b_adc) for s in res.specs]


def _exhaustive(size: int) -> set:
    genes, objs = rexplorer.full_design_space(size)
    mask = np.asarray(rpareto.non_dominated_mask(objs))
    return {tuple(int(x) for x in g)
            for g, m in zip(np.asarray(genes), mask) if m}


def _ref_quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


@pytest.fixture
def fresh_cpu_session(monkeypatch):
    """A fresh process-wide CPU session, so no front is served from an
    earlier test's cache."""
    monkeypatch.setattr(api, "_DEVICE_SESSIONS", {})
    return lambda: api.default_session(device="cpu")


@pytest.fixture
def reference_evaluate(monkeypatch):
    """Patch the port's `evaluate_op` to the reference's jitted operator
    on the reference's operands of the same cell (16384)."""
    space = rnsga2.space_operands(rnsga2.NSGA2Config(array_size=16384))
    ev = jax.jit(rnsga2.evaluate_op)

    def evaluate(genes, sp):
        g = genes.numpy()
        return torch.from_numpy(np.stack([
            np.asarray(ev(jnp.asarray(g[c]), space))
            for c in range(len(g))]))

    monkeypatch.setattr(tnsga2, "evaluate_op", evaluate)


# -- the deprecated shims -------------------------------------------------

@pytest.mark.parametrize("name", ["explore", "explore_sizes"])
def test_shims_warn_like_the_reference(name, fresh_cpu_session):
    kw = dict(pop_size=48, generations=4)
    args = (4096,) if name == "explore" else ((4096,),)
    with pytest.warns(DeprecationWarning,
                      match=rf"^repro_torch\.core\.explorer\.{name} is "
                            rf"deprecated"):
        getattr(texplorer, name)(*args, device="cpu", **kw)
    with pytest.warns(DeprecationWarning,
                      match=rf"^repro\.core\.explorer\.{name} is deprecated"):
        getattr(rexplorer, name)(*args, **kw)


@pytest.mark.parametrize("size", SIZES)
def test_explore_front_matches_reference_and_exhaustive(size):
    """At the default budget both packages find the whole exhaustive
    front (as `TestNSGA2.test_recovers_true_front_16kb` checks for 60 %
    of it); the metrics of the shared points agree at rtol 1e-6."""
    with pytest.warns(DeprecationWarning):
        port = texplorer.explore(size, device="cpu")
    ref = _ref_quiet(rexplorer.explore, size)
    assert _key(port) == _key(ref) == _exhaustive(size)
    assert _spec_tuples(port) == _spec_tuples(ref)
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(port.metrics[k], np.asarray(v),
                                   rtol=1e-6, err_msg=k)


def test_explore_sizes_is_one_dispatch_of_explore_fronts(fresh_cpu_session):
    session = fresh_cpu_session()
    with pytest.warns(DeprecationWarning):
        swept = texplorer.explore_sizes(SIZES, device="cpu")
    assert session.stats["explorer_dispatches"] == 1
    assert list(swept) == list(SIZES)
    for size in SIZES:
        with pytest.warns(DeprecationWarning):
            one = texplorer.explore(size, device="cpu", seed=0)
        assert _spec_tuples(swept[size]) == _spec_tuples(one)
        assert _key(swept[size]) == _exhaustive(size)


def test_distill_and_layout_matches_reference():
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.core\.explorer\.distill_and_"):
        port, port_layouts = texplorer.distill_and_layout(
            16384, device="cpu", **DISTILL)
    ref, ref_layouts = _ref_quiet(rexplorer.distill_and_layout, 16384,
                                  **DISTILL)
    assert len(port) > 0 and _spec_tuples(port) == _spec_tuples(ref)
    want = ref_layouts.metrics_rows()
    got = port_layouts.metrics_rows()
    assert len(got) == len(want) == len(port)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], (bool, int, np.integer)):
                assert g[k] == w[k], k
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                           err_msg=k)


# -- batched explorer ------------------------------------------------------

def test_stack_spaces_bit_equal():
    cfgs = [rnsga2.NSGA2Config(array_size=s) for s in SIZES]
    ref = rbatched.stack_spaces([rnsga2.space_operands(c) for c in cfgs])
    port = tbatched.stack_spaces([
        tnsga2.space_operands(tnsga2.NSGA2Config(array_size=s))
        for s in SIZES])
    for name in ("array_size", "gene_lo", "gene_hi"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name in ref.cal._fields:
        np.testing.assert_array_equal(getattr(port.cal, name).numpy(),
                                      np.asarray(getattr(ref.cal, name)),
                                      err_msg=name)


def test_explore_batch_is_explore_cells():
    kw = dict(pop_size=48, generations=6, device="cpu")
    got = tbatched.explore_batch((4096, 16384), (0, 1), **kw)
    want = tbatched.explore_cells([(4096, 0), (4096, 1), (16384, 0),
                                   (16384, 1)], **kw)
    assert list(got) == list(want)
    ref = rbatched.explore_batch((4096, 16384), (0, 1), pop_size=48,
                                 generations=6)
    assert list(got) == list(ref)
    for cell in got:
        assert _spec_tuples(got[cell]) == _spec_tuples(want[cell])
    with pytest.raises(ValueError, match="at least one"):
        tbatched.explore_batch((), device="cpu")


# -- estimator -------------------------------------------------------------

def test_objectives_match_reference():
    genes, _ = rexplorer.full_design_space(16384)
    g = np.asarray(genes)
    h = (2.0 ** g[:, 0]).astype(np.float32)
    w = (16384 / h).astype(np.float32)
    l = (2.0 ** g[:, 1]).astype(np.float32)
    b = g[:, 2].astype(np.float32)
    want = np.asarray(restimator.objectives(h, w, l, b))
    got = testimator.objectives(*(torch.from_numpy(x) for x in (h, w, l, b)))
    assert got.shape == want.shape == (len(g), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# -- NSGA-II, config-static forms ----------------------------------------

def test_run_matches_reference(reference_evaluate):
    cfg_r = rnsga2.NSGA2Config(array_size=16384, pop_size=64,
                               generations=5)
    cfg_t = tnsga2.NSGA2Config(array_size=16384, pop_size=64,
                               generations=5)
    key = jax.random.key(11)
    want = rnsga2.run(cfg_r, key)
    got = tnsga2.run(cfg_t, draws=JaxDraws([key]), device="cpu")
    assert isinstance(got, tnsga2.Population)
    np.testing.assert_array_equal(got.genes.numpy(), np.asarray(want.genes))
    np.testing.assert_array_equal(got.objs.numpy(), np.asarray(want.objs))


def test_run_with_seed_is_feasible_and_on_the_front():
    cfg = tnsga2.NSGA2Config(array_size=16384)
    pop = tnsga2.run(cfg, seed=0, device="cpu")
    assert pop.genes.shape == (256, 3) and pop.objs.shape == (256, 4)
    assert float(tnsga2.constraint_violation(pop.genes, cfg).max()) == 0.0
    res = texplorer.pareto_result_from_population(
        16384, pop.genes.numpy(), pop.objs.numpy())
    assert _key(res) == _exhaustive(16384)


def test_init_population_bit_equal():
    cfg_r = rnsga2.NSGA2Config(array_size=4096, pop_size=40)
    cfg_t = tnsga2.NSGA2Config(array_size=4096, pop_size=40)
    key = jax.random.key(5)
    sp = rnsga2.space_operands(cfg_r)
    lo, hi = np.asarray(sp.gene_lo), np.asarray(sp.gene_hi)
    cols = np.stack([np.asarray(jax.random.randint(
        k, (40,), int(lo[i]), int(hi[i]) + 1))
        for i, k in enumerate(jax.random.split(key, 3))], 1)
    got = tnsga2.init_population(torch.from_numpy(cols), cfg_t)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(rnsga2.init_population(key, cfg_r)))
    seeded = tnsga2.init_population(3, cfg_t, device="cpu")
    assert seeded.shape == (40, 3) and seeded.dtype == torch.int32
    assert torch.equal(tnsga2.repair(seeded, cfg_t), seeded)


def test_generation_step_bit_equal(reference_evaluate):
    cfg_r = rnsga2.NSGA2Config(array_size=16384, pop_size=48)
    cfg_t = tnsga2.NSGA2Config(array_size=16384, pop_size=48)
    genes = rnsga2.init_population(jax.random.key(1), cfg_r)
    objs = rnsga2.evaluate(genes, cfg_r)
    key = jax.random.key(2)
    want = rnsga2.generation_step(key, genes, objs, cfg_r)
    draws = JaxDraws.step([key], 48, 48,
                          tnsga2.EvolveStatics.from_config(cfg_t))
    tg = torch.tensor(np.asarray(genes))
    to = torch.tensor(np.asarray(objs))
    for d in (draws, tnsga2.GenerationDraws(*(x[0] for x in draws))):
        got = tnsga2.generation_step(d, tg, to, cfg_t)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    seeded = tnsga2.generation_step(7, tg, to, cfg_t)
    assert seeded[0].shape == (48, 3) and seeded[1].shape == (48, 4)


def test_repair_decode_violation_bit_equal():
    rng = np.random.default_rng(0)
    raw = rng.integers(-3, 16, size=(200, 3)).astype(np.int32)
    for size in SIZES:
        cfg_r = rnsga2.NSGA2Config(array_size=size)
        cfg_t = tnsga2.NSGA2Config(array_size=size)
        t = torch.from_numpy(raw)
        np.testing.assert_array_equal(
            tnsga2.constraint_violation(t, cfg_t).numpy(),
            np.asarray(rnsga2.constraint_violation(jnp.asarray(raw), cfg_r)))
        fixed = tnsga2.repair(t, cfg_t)
        np.testing.assert_array_equal(
            fixed.numpy(), np.asarray(rnsga2.repair(jnp.asarray(raw), cfg_r)))
        assert float(tnsga2.constraint_violation(fixed, cfg_t).max()) == 0
        for got, want in zip(tnsga2.decode(fixed, cfg_t),
                             rnsga2.decode(jnp.asarray(fixed.numpy()),
                                           cfg_r)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- kernels' public helpers -------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_rank_and_crowd_matches_reference(batched):
    genes, objs = rexplorer.full_design_space(65536)
    f = np.asarray(objs)[:200]
    want_r, want_c = rdom.rank_and_crowd(jnp.asarray(f), interpret=True)
    t = torch.from_numpy(f)
    ranks, crowd = tdom.rank_and_crowd(t[None] if batched else t)
    if batched:
        ranks, crowd = ranks[0], crowd[0]
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(want_r))
    np.testing.assert_allclose(crowd.numpy(), np.asarray(want_c), rtol=1e-6)


@pytest.mark.parametrize("shape", [(17, 23), (3, 9, 31)])
def test_relax_once_bit_equal(shape):
    rng = np.random.default_rng(len(shape))
    free = rng.random(shape) > 0.3
    dist = np.where(rng.random(shape) < 0.05, 0, rmaze.INF).astype(np.int32)
    d_r, d_t = jnp.asarray(dist), torch.from_numpy(dist)
    for _ in range(6):
        d_r = rmaze.relax_once(d_r, jnp.asarray(free))
        d_t = tmaze.relax_once(d_t, torch.from_numpy(free))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_r))
    assert d_t.dtype == torch.int32


def test_mesh_axis():
    assert tdist.MESH_AXIS == rdist.MESH_AXIS == "islands"


# -- public names ----------------------------------------------------------

# Names of the reference with no counterpart, each with its reason
# (ROADMAP, "AST diff of the public top-level names").
EXCLUDED_EVERYWHERE = {"Array", "PyTree"}          # jax type aliases
EXCLUDED = {
    "core/nsga2.py": {"TRACE_COUNTS", "run_cell_jit"},   # jit-only
    "kernels/flash_attention/kernel.py": {"NEG_INF"},
    "parallel/axes.py": {"shard_map"},                   # JAX glue
    "launch/dryrun.py": {"collective_bytes"},            # XLA HLO reading
    "analysis/callgraph.py": {"TRACE_WRAPPERS"},         # jit tracer roots
}


def _public_names(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and \
                path.name == "__init__.py":
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


def test_public_names_match_reference():
    missing = {}
    for ref in sorted((SRC / "repro").rglob("*.py")):
        rel = ref.relative_to(SRC / "repro").as_posix()
        port = SRC / "repro_torch" / rel
        assert port.exists(), f"no counterpart of src/repro/{rel}"
        gone = _public_names(ref) - _public_names(port) - EXCLUDED_EVERYWHERE
        gone -= EXCLUDED.get(rel, set())
        if rel.startswith("kernels/"):
            gone = {n for n in gone if not n.endswith("_kernel")}
        if rel == "core/constants.py":
            gone = {n for n in gone if not re.match(r"TPU_", n)}
        if gone:
            missing[rel] = sorted(gone)
    assert missing == {}
