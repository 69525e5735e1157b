"""Estimator parity: the port's objectives over the exhaustive design
spaces against the reference's, on the same calibration operands."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import explorer as rexplorer
from repro.core import nsga2 as rnsga2
from repro.core import pareto as rpareto
from repro.core import estimator as restimator
from repro_torch.core import estimator as testimator
from repro_torch.core import explorer as texplorer
from repro_torch.core import nsga2 as tnsga2
from repro_torch.core import pareto as tpareto
from torch_port_helpers import port_space

SPACE_POINTS = {4096: 90, 16384: 161, 65536: 200}


@pytest.mark.parametrize("size", sorted(SPACE_POINTS))
def test_objectives_match_reference(size):
    genes, objs = rexplorer.full_design_space(size)
    genes, objs = np.array(genes), np.array(objs)
    assert len(genes) == SPACE_POINTS[size]
    space = port_space([rnsga2.NSGA2Config(array_size=size)])
    got = tnsga2.evaluate_op(torch.from_numpy(genes)[None], space)[0].numpy()
    # log10/pow differ by ulps between XLA and torch's libm
    np.testing.assert_allclose(got, objs, rtol=1e-6)
    # ...but never enough to flip a dominance: ranks are exactly equal
    want = np.asarray(rpareto.non_dominated_rank(jnp.asarray(objs)))
    np.testing.assert_array_equal(
        tpareto.non_dominated_rank(torch.from_numpy(got)).numpy(), want)


def test_cal_operands_equal_reference():
    ref = restimator.cal_operands()
    got = testimator.cal_operands()
    for name in ref._fields:
        assert np.float32(getattr(got, name)) == np.asarray(getattr(ref, name)), name


@pytest.mark.parametrize("size", sorted(SPACE_POINTS))
def test_full_design_space_and_report(size):
    rg, ro = rexplorer.full_design_space(size)
    tg, to = texplorer.full_design_space(size)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(rg))
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-6)
    g = np.asarray(rg)
    h = (2.0 ** g[:, 0]).astype(np.float32)
    l = (2.0 ** g[:, 1]).astype(np.float32)
    b = g[:, 2].astype(np.float32)
    w = (size / h).astype(np.float32)
    ref = restimator.evaluate_report(h, w, l, b)
    got = testimator.evaluate_report(h, w, l, b)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, err_msg=k)
