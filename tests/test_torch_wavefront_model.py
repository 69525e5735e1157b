"""The numpy model of the standalone `wavefront` kernel's algorithm
(`tests/wavefront_model.py`: the moving row window, the frontier words it
leaves behind, the levels kept until the field is written once, the
byte-to-bit read of occ and seed) against the port's plain version
`ref.wavefront_distance_ref` and the reference's
`repro.kernels.maze_route.ops.wavefront_distance`, bit for bit, on the
CPU."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.maze_route import ops as rops
from repro_torch.kernels.maze_route import ref as tref
from test_torch_flow import CASES
from wavefront_model import (INF, _grid_words, fork, load_bits,
                             vertical_snake, wavefront_model)
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)


def _batched(occ, seed):
    occ, seed = np.asarray(occ, bool), np.asarray(seed, bool)
    return (occ[None], seed[None]) if occ.ndim == 2 else (occ, seed)


def _plain(occ, seed, grids=None):
    return tref.wavefront_distance_ref(
        torch.from_numpy(occ), torch.from_numpy(seed),
        None if grids is None else torch.from_numpy(grids)).numpy()


def _reference(occ, seed):
    """The reference's field, its sweeping ref and its default engine
    (they agree)."""
    ref = np.asarray(rops.wavefront_distance(occ, seed, impl="ref"))
    np.testing.assert_array_equal(
        ref, np.asarray(rops.wavefront_distance(occ, seed)))
    return ref


def _levels(dist) -> list[int]:
    return [int(d[d < INF].max()) + 1 if (d < INF).any() else 0
            for d in dist]


def _check(occ, seed, grids=None):
    """The model equal to the plain version, without its row window (the
    kernel) and with it, its levels the field's largest value plus one;
    returns the plain field and the windowed model's stale reads."""
    want = _plain(occ, seed, grids)
    got, levels, stale = wavefront_model(occ, seed, grids)
    np.testing.assert_array_equal(got, want)
    assert list(levels) == _levels(want) and not stale.any()
    got, levels, stale = wavefront_model(occ, seed, grids, window=True)
    np.testing.assert_array_equal(got, want)
    assert list(levels) == _levels(want)
    return want, stale


@pytest.mark.parametrize("case", range(len(CASES)))
def test_model_equals_plain_and_reference(case):
    occ, seed = _batched(*CASES[case])
    want, stale = _check(occ, seed)
    for b in range(occ.shape[0]):
        np.testing.assert_array_equal(want[b], _reference(occ[b], seed[b]))


@pytest.mark.parametrize("name", ["snake", "fork"])
def test_model_on_corridors(name):
    """The window moves away from the rows where the frontier began; the
    frontier words it leaves behind are read again on the fork (stale
    reads without clearing, none with), and the field is exact both
    ways."""
    occ, seed = vertical_snake(20, 9) if name == "snake" else fork()
    want, stale = _check(occ, seed)
    np.testing.assert_array_equal(want[0], _reference(occ[0], seed[0]))
    _, _, stale_cleared = wavefront_model(occ, seed, window=True,
                                          clear=True)
    assert stale_cleared.sum() == 0
    if name == "fork":
        assert stale.sum() > 0


def _seeded(kind: str):
    rng = np.random.default_rng(5)
    occ = rng.random((2, 23, 70)) < 0.25
    seed = np.zeros_like(occ)
    if kind == "several":
        for b in range(2):
            seed[b, rng.integers(0, 23, 4), rng.integers(0, 70, 4)] = True
    elif kind == "occupied":
        ys, xs = np.nonzero(occ[0])
        seed[0, ys[:3], xs[:3]] = True
        seed[1, 0, 0] = occ[1, 0, 0] = True
    elif kind == "walled":
        seed[:, 10, 33] = True
        occ[:, 9:12, 32:35] = True          # blocked all round
        occ[:, 10, 33] = False
    return occ, seed


@pytest.mark.parametrize("kind", ["several", "none", "occupied", "walled"])
def test_model_seeds(kind):
    occ, seed = _seeded(kind)
    want, _ = _check(occ, seed)
    for b in range(2):
        np.testing.assert_array_equal(want[b], _reference(occ[b], seed[b]))
    if kind == "none":
        assert (want == INF).all()
    if kind == "walled":
        assert ((want == 0) == seed).all() and (want[seed == 0] == INF).all()


def test_model_grids_smaller_than_plane():
    """Each grid's own extent: its cells as the reference computes them on
    the grid alone, INF beyond (seeds there ignored)."""
    rng = np.random.default_rng(9)
    occ = rng.random((4, 30, 75)) < 0.2
    seed = rng.random((4, 30, 75)) < 0.004
    seed[:, 29, 74] = True                           # beyond every grid
    grids = np.array([[30, 75], [12, 40], [1, 33], [29, 1]], np.int32)
    want, _ = _check(occ, seed, grids)
    for b, (gh, gw) in enumerate(grids):
        np.testing.assert_array_equal(
            want[b, :gh, :gw], _reference(occ[b, :gh, :gw], seed[b, :gh, :gw]))
        assert (want[b, gh:] == INF).all() and (want[b, :, gw:] == INF).all()


@pytest.mark.parametrize("addr0", range(4))
def test_load_bits_reads_the_grid_words(addr0):
    """The kernel's byte-to-bit read of a flat (H, W) plane whose first
    byte sits at any address mod 4 gives the model's words, for bytes of
    any value (not only 0 / 1), at widths around a word."""
    rng = np.random.default_rng(addr0)
    for h, w in ((3, 31), (3, 32), (3, 33), (2, 274), (5, 1)):
        plane = rng.integers(0, 4, (h, w)).astype(np.uint8)
        plane[rng.random((h, w)) < 0.3] = 0
        flat = plane.reshape(-1)
        words, _, _ = _grid_words(plane != 0, np.zeros((h, w), bool), w)
        wpr = (w + 31) // 32
        for k, want in enumerate(words):
            r, x0 = divmod(k, wpr)
            x0 *= 32
            assert load_bits(flat, r * w + x0, min(32, w - x0), addr0) == want


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 40), st.integers(1, 80), st.floats(0.0, 0.6),
       st.integers(0, 3), st.booleans(), st.integers(0, 2 ** 31 - 1))
def test_model_sweep(h, w, density, n_seeds, with_grids, seed_):
    rng = np.random.default_rng(seed_)
    occ = rng.random((2, h, w)) < density
    seed = np.zeros_like(occ)
    for b in range(2):
        flat = rng.choice(h * w, size=min(n_seeds, h * w), replace=False)
        seed[b, flat // w, flat % w] = True
    grids = (np.stack([rng.integers(1, h + 1, 2), rng.integers(1, w + 1, 2)],
                      1).astype(np.int32) if with_grids else None)
    _check(occ, seed, grids)
