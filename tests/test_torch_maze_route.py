"""maze_route parity: the port's plain wavefront equals its BFS oracle,
the reference's sweeping ref and the reference's Pallas kernel
(interpret mode); the plain backtrace equals the reference's
`_dir_field` / `_trace_one`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.eda import batched_flow as rflow
from repro.kernels.maze_route import ops as rops
from repro.kernels.maze_route import wavefront_distance_ref as rwave
from repro_torch.kernels.maze_route import (INF, pad_blocked,
                                            wavefront_distance,
                                            wavefront_distance_bfs)
from repro_torch.kernels.maze_route import kernel as tkernel
from repro_torch.kernels.maze_route import ref as tref
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)


def _grids(seed: int, b: int = 3, h: int = 23, w: int = 37, p: float = 0.3):
    """Random occupancy, 1-2 seeds per grid (some on occupied cells), and
    a blocked column along the right edge (a pad-like boundary)."""
    rng = np.random.default_rng(seed)
    occ = rng.random((b, h, w)) < p
    occ[:, :, -1] = True
    seed_ = np.zeros((b, h, w), bool)
    for i in range(b):
        for _ in range(rng.integers(1, 3)):
            seed_[i, rng.integers(h), rng.integers(w)] = True
        ys, xs = np.nonzero(occ[i])
        seed_[i, ys[0], xs[0]] = True                # an occupied seed
    return occ, seed_


@pytest.mark.parametrize("seed", range(4))
def test_plain_wavefront_equals_oracles(seed):
    occ, sd = _grids(seed, p=0.15 + 0.1 * seed)
    got = wavefront_distance(torch.from_numpy(occ), torch.from_numpy(sd)).numpy()
    np.testing.assert_array_equal(got, wavefront_distance_bfs(occ, sd))
    np.testing.assert_array_equal(got, np.asarray(rwave(occ, sd)))
    assert got.dtype == np.int32 and (got[sd] == 0).all()


def test_plain_wavefront_equals_reference_kernel():
    occ, sd = _grids(7, b=2, h=10, w=20)
    want = np.asarray(rops.wavefront_distance(occ, sd, impl="kernel",
                                              interpret=True))
    got = tkernel.wavefront(torch.from_numpy(occ), torch.from_numpy(sd))
    np.testing.assert_array_equal(got.numpy(), want)


def test_grids_and_blocked_padding():
    """Padding with blocked cells, or naming each grid's own extent,
    leaves every real cell's distance unchanged and the pad INF."""
    occ, sd = _grids(11)
    want = wavefront_distance_bfs(occ, sd)
    occ_p, sd_p = pad_blocked(torch.from_numpy(occ), torch.from_numpy(sd),
                              30, 64)
    got = wavefront_distance(occ_p, sd_p)
    np.testing.assert_array_equal(got[:, :23, :37].numpy(), want)
    assert (got[:, 23:] == INF).all() and (got[:, :, 37:] == INF).all()
    # a free pad region named as outside the grids behaves as blocked
    free_pad = torch.zeros((3, 30, 64), dtype=torch.bool)
    free_pad[:, :23, :37] = torch.from_numpy(occ)
    seeds = torch.zeros_like(free_pad)
    seeds[:, :23, :37] = torch.from_numpy(sd)
    grids = torch.tensor([[23, 37]] * 3, dtype=torch.int32)
    got = wavefront_distance(free_pad, seeds, grids)
    np.testing.assert_array_equal(got[:, :23, :37].numpy(), want)
    assert (got[:, 23:] == INF).all() and (got[:, :, 37:] == INF).all()


def _traced_case(seed: int):
    occ, sd = _grids(seed, p=0.2)
    sd[:] = False
    rng = np.random.default_rng(seed)
    b, h, w = occ.shape
    for i in range(b):
        sd[i, rng.integers(h), rng.integers(w - 1)] = True
    dist = wavefront_distance_bfs(occ, sd)
    tgts = np.stack([rng.integers(0, h, (b, 2)), rng.integers(0, w, (b, 2))],
                    -1).astype(np.int32)
    ys, xs = np.nonzero(occ[0][:, :-1])
    tgts[0, 0] = (ys[0], xs[0])                  # a blocked target
    tmask = np.array([[True, True], [True, False], [True, True]])
    return dist, tgts, tmask


@pytest.mark.parametrize("seed", range(3))
def test_plain_backtrace_equals_reference(seed):
    dist, tgts, active = _traced_case(seed)
    np.testing.assert_array_equal(
        tref.dir_field(torch.from_numpy(dist)).numpy(),
        np.asarray(jax.vmap(rflow._dir_field)(jnp.asarray(dist))).astype(np.uint8))
    inc, wl, reach = tref.trace_targets(torch.from_numpy(dist),
                                        torch.from_numpy(tgts),
                                        torch.from_numpy(active))
    rdist = jnp.asarray(dist)
    trace = jax.vmap(jax.vmap(rflow._trace_one, in_axes=(None, None, 0, 0)))
    rinc, rwl, rreach = trace(rdist, jax.vmap(rflow._dir_field)(rdist),
                              jnp.asarray(tgts), jnp.asarray(active))
    np.testing.assert_array_equal(
        inc.numpy(), np.asarray(rinc).astype(np.int32).sum(1))
    np.testing.assert_array_equal(wl.numpy(), np.asarray(rwl))
    np.testing.assert_array_equal(reach.numpy(), np.asarray(rreach))


def test_trace_paths_commits_only_routable_specs():
    dist, tgts, tmask = _traced_case(1)
    b = dist.shape[0]
    nmask = torch.tensor([True, True, False])
    occ = torch.zeros(dist.shape, dtype=torch.int32)
    routed, failed, wl = (torch.zeros(b, dtype=torch.int32) for _ in range(3))
    tkernel.trace_paths(torch.from_numpy(dist), torch.from_numpy(tgts),
                        torch.from_numpy(tmask), nmask, occ, routed, failed, wl)
    inc, wls, reach = tref.trace_targets(
        torch.from_numpy(dist), torch.from_numpy(tgts),
        torch.from_numpy(tmask) & nmask[:, None])
    ok = nmask & (reach | ~torch.from_numpy(tmask)).all(1)
    assert torch.equal(routed, ok.int())
    assert torch.equal(failed, (nmask & ~ok).int())
    assert torch.equal(occ, inc * ok[:, None, None].int())
    assert torch.equal(wl, wls.sum(1, dtype=torch.int32) * ok.int())
