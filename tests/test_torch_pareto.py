"""Pareto utilities and the pareto_dom ops: the port bit-equal to the
reference, on populations with duplicate points, ties on single
objectives and +inf pad rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pareto as rpareto
from repro.kernels.pareto_dom import ops as rops
from repro_torch.core import nsga2 as tnsga2
from repro_torch.core import pareto as tpareto
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.pareto_dom import kernel as tkernel
from repro_torch.kernels.pareto_dom import ops as tops
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

_crowd_ref = jax.jit(rpareto.crowding_distance)


def _objectives(p: int, seed: int) -> np.ndarray:
    """(2, p, 4): cell 0 on a coarse integer lattice (many ties and
    duplicates), cell 1 continuous with copied rows and one tied
    column; the last 3 rows of both are +inf pads."""
    rng = np.random.default_rng(seed)
    f = np.empty((2, p, 4), np.float32)
    f[0] = rng.integers(0, 5, (p, 4))
    f[1] = rng.normal(size=(p, 4))
    f[1, p // 2:p // 2 + 5] = f[1, :5]
    f[1, :, 2] = np.round(f[1, :, 2])
    f[:, -3:] = np.inf
    return f


@pytest.mark.parametrize("p", [37, 512])
def test_dominance_rank_crowding_bit_equal(p):
    f = _objectives(p, seed=p)
    ft = torch.from_numpy(f)
    dom = tpareto.dominance_matrix(ft).numpy()
    ranks = tpareto.non_dominated_rank(ft)
    crowd = tpareto.crowding_distance(ft, ranks).numpy()
    mask = tpareto.non_dominated_mask(ft).numpy()
    for c in range(2):
        fc = jnp.asarray(f[c])
        rr = rpareto.non_dominated_rank(fc)
        np.testing.assert_array_equal(dom[c], np.asarray(rpareto.dominance_matrix(fc)))
        np.testing.assert_array_equal(ranks[c].numpy(), np.asarray(rr))
        np.testing.assert_array_equal(mask[c], np.asarray(rpareto.non_dominated_mask(fc)))
        # bit-equal, NaN and inf patterns included
        np.testing.assert_array_equal(
            crowd[c].view(np.int32), np.asarray(_crowd_ref(fc, rr)).view(np.int32))


@pytest.mark.parametrize("p", [37, 512])
def test_plain_ops_match_reference_kernels(p):
    """CPU tensors take the plain versions; they equal the reference's
    Pallas kernels run in interpret mode."""
    f = _objectives(p, seed=p + 1)
    ft = torch.from_numpy(f)
    before = dict(LAUNCHES)
    ranks = tops.non_dominated_rank(ft).numpy()
    dom = tops.dominance_matrix(ft).numpy()
    routes = [tnsga2.rank_and_crowd(ft, tnsga2.EvolveStatics(
        use_pallas_dominance=dom_route)) for dom_route in (False, True)]
    assert dict(LAUNCHES) == before          # no kernel launched on the CPU
    for c in range(2):
        fc = jnp.asarray(f[c])
        np.testing.assert_array_equal(
            ranks[c], np.asarray(rops.non_dominated_rank(fc, interpret=True)))
        np.testing.assert_array_equal(
            dom[c], np.asarray(rops.dominance_matrix(fc, interpret=True)))
    for r2, c2 in routes:
        np.testing.assert_array_equal(r2.numpy(), ranks)
        np.testing.assert_array_equal(
            c2.numpy(), tpareto.crowding_distance(ft, r2).numpy())


def test_kernel_wrappers_check_inputs():
    with pytest.raises(ValueError):
        tkernel.nds_rank(torch.zeros((1, 30, 4)))           # P % 32 != 0
    with pytest.raises(ValueError):
        tkernel.dominance_matrix(torch.zeros((30, 4)))      # no cell dim
