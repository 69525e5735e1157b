"""The numpy model of the standalone `nds_rank` kernel's peel for P <= 512
(`tests/nds_rank_model.py`: a point's dominator words in its thread's
registers, alive words as warp ballots by front parity) against the
port's `pareto.non_dominated_rank` and the reference's
`repro.core.pareto.non_dominated_rank`, bit for bit, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import pareto as rpareto
from repro_torch.core import pareto as tpareto
from nds_rank_model import dominator_words, nds_rank_model
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)


def _objectives(cells: int, p: int, m: int, seed: int) -> np.ndarray:
    """Even cells on a coarse integer lattice (ties, duplicates), odd ones
    continuous with copied rows; the last 3 rows of each are +inf pads."""
    rng = np.random.default_rng(seed)
    f = np.empty((cells, p, m), np.float32)
    for c in range(cells):
        if c % 2 == 0:
            f[c] = rng.integers(0, 5, (p, m))
        else:
            f[c] = rng.normal(size=(p, m))
            f[c, p // 2:p // 2 + 5] = f[c, :5]
    f[:, -3:] = np.inf
    return f


@pytest.mark.parametrize("p,m,cells", [(32, 4, 3), (96, 4, 8), (512, 4, 2),
                                       (96, 1, 4), (96, 8, 4), (512, 8, 2)])
def test_model_equals_plain_and_reference(p, m, cells):
    f = _objectives(cells, p, m, seed=p + m)
    got, fronts = nds_rank_model(f)
    want = tpareto.non_dominated_rank(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(fronts) == list(want.max(-1) + 1)
    for c in range(cells):
        np.testing.assert_array_equal(
            got[c], np.asarray(rpareto.non_dominated_rank(jnp.asarray(f[c]))))


def test_dominator_words_are_the_dominance_matrix():
    f = _objectives(2, 96, 4, seed=3)
    dom = tpareto.dominance_matrix(torch.from_numpy(f)).numpy()
    for c in range(2):
        words = dominator_words(f[c])
        bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
        np.testing.assert_array_equal(bits.reshape(96, 96).astype(bool),
                                      dom[c].T)


@settings(max_examples=30, deadline=None)
@given(st.sampled_from([32, 64, 96, 160]), st.integers(1, 5),
       st.integers(2, 6), st.integers(0, 2 ** 31 - 1))
def test_model_sweep(p, m, levels, seed):
    """Lattices of 2-6 values a coordinate: many ties and duplicates."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, levels, (2, p, m)).astype(np.float32)
    f[:, rng.integers(0, p)] = np.inf
    got, _ = nds_rank_model(f)
    np.testing.assert_array_equal(
        got, tpareto.non_dominated_rank(torch.from_numpy(f)).numpy())
