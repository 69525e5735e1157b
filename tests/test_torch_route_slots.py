"""`route_slots` on the CPU: its plain version equals the reference's
`_route_program` (the scan engine's slot loop, jnp sweeping ref), and
a numpy model of the kernel's algorithm (`route_slots_model.py`: a
bit-parallel BFS that stops at the last target, uint16 counts, uint32
past 32,767 masked targets a grid) equals
the plain version, on seeded buckets and a hypothesis sweep.  The
kernel itself is held to the plain version on the card
(`test_torch_kernels_cuda.py`, `chip_smoke.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.eda import batched_flow as rflow
from repro_torch.kernels.maze_route import kernel as tkernel
from repro_torch.kernels.maze_route import ops as tops
from repro_torch.kernels.maze_route import ref as tref
from route_slots_model import (hub_heavy_bucket, random_bucket,
                               route_slots_model)
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

# Mixed grid sizes in one padded plane (the tallest and the widest are
# different grids), as a layout bucket pads its specs.
GRIDS = [(14, 40), (20, 23), (7, 9), (16, 33)]
SLOTS = 9
CASES = [(seed, cap, p) for seed, cap, p in
         ((0, 4, 0.2), (1, 1, 0.1), (2, 4, 0.35), (3, 1, 0.25), (4, 2, 0.3))]


def _torch(bucket):
    occ0, hubs, tgts, tmask, nmask, grids = bucket
    return (torch.from_numpy(occ0), torch.from_numpy(hubs),
            torch.from_numpy(tgts), torch.from_numpy(tmask),
            torch.from_numpy(nmask), torch.from_numpy(grids))


def _plain(bucket, cap):
    return [x.numpy() for x in tref.route_slots_ref(*_torch(bucket), cap)]


@pytest.mark.parametrize("seed,cap,p_full", CASES)
def test_plain_equals_reference_route_program(seed, cap, p_full):
    bucket = random_bucket(seed, GRIDS, SLOTS, cap, p_full=p_full)
    occ0, hubs, tgts, tmask, nmask, _ = bucket
    nets = rflow.NetBatch(jnp.asarray(hubs), jnp.asarray(tgts),
                          jnp.asarray(tmask), jnp.asarray(nmask))
    want = rflow._route_program(jnp.asarray(occ0), nets, capacity=cap,
                                use_kernel=False)
    got = _plain(bucket, cap)
    for g, w_, what in zip(got, want, ("occ", "routed", "failed",
                                       "wirelen")):
        np.testing.assert_array_equal(g, np.asarray(w_), err_msg=what)
    assert got[1].sum() > 0 and got[2].sum() > 0   # routes and failures


@pytest.mark.parametrize("seed,cap,p_full", CASES)
def test_model_equals_plain(seed, cap, p_full):
    bucket = random_bucket(seed, GRIDS, SLOTS, cap, p_full=p_full)
    got = route_slots_model(*bucket, cap)
    for g, w_, what in zip(got, _plain(bucket, cap),
                           ("occ", "routed", "failed", "wirelen")):
        np.testing.assert_array_equal(g, w_, err_msg=what)
    assert (got[4] > 0).all()


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), cap=st.integers(1, 3),
       p_full=st.floats(0.0, 0.5),
       grids=st.lists(st.tuples(st.integers(5, 12), st.integers(5, 40)),
                      min_size=1, max_size=3),
       slots=st.integers(4, 7), targets=st.integers(1, 3))
def test_model_equals_plain_sweep(seed, cap, p_full, grids, slots, targets):
    bucket = random_bucket(seed, grids, slots, cap, targets, p_full)
    got = route_slots_model(*bucket, cap)
    for g, w_ in zip(got, _plain(bucket, cap)):
        np.testing.assert_array_equal(g, w_)


# More slots than fit 16-bit counts at T S + 1 (T S = 32,800), with fewer
# masked targets (A = 23,540, 2 A + 1 < 2^16): the counts' offset is A + 1.
LONG_BUCKET = dict(seed=6, grids=[(9, 40)], slots=16_400, capacity=4,
                   p_full=0.1)


def test_model_equals_plain_past_16k_slots():
    bucket = random_bucket(**LONG_BUCKET)
    tmask, nmask = bucket[3], bucket[4]
    assert tmask.shape[2] * tmask.shape[1] >= 2 ** 15
    assert 2 * int((tmask & nmask[..., None]).sum()) + 1 < 2 ** 16
    got = route_slots_model(*bucket, LONG_BUCKET["capacity"])
    for g, w_ in zip(got, _plain(bucket, LONG_BUCKET["capacity"])):
        np.testing.assert_array_equal(g, w_)
    assert got[1].sum() > 0


def test_model_equals_plain_past_32k_targets():
    """51,000 masked targets a grid (2 A + 1 > 2^16 - 1): the model keeps
    uint32 counts, as the kernel does, and a hub's count passes 2^16."""
    bucket = hub_heavy_bucket()
    occ0, tmask, nmask = bucket[0], bucket[3], bucket[4]
    visits = int((tmask & nmask[..., None]).sum((1, 2)).max())
    assert visits > 2 ** 15 - 1
    got = route_slots_model(*bucket, 4)
    for g, w_ in zip(got, _plain(bucket, 4)):
        np.testing.assert_array_equal(g, w_)
    # the largest offset count u = occ - occ0 + K, K = A + 1 (see the model)
    assert int((got[0] - occ0).max()) + visits + 1 > 2 ** 16 - 1
    assert (got[1] > 0).all() and (got[2] > 0).all() and (got[4] > 0).all()


def test_ops_takes_any_layout():
    """`ops.route_slots` makes its inputs contiguous and of the kernel's
    dtypes (int64 counts, uint8 masks, non-contiguous nets)."""
    bucket = random_bucket(5, GRIDS, SLOTS, 4)
    occ0, hubs, tgts, tmask, nmask, grids = _torch(bucket)
    got = tops.route_slots(occ0.long(), hubs.transpose(0, 1).contiguous()
                           .transpose(0, 1), tgts.long(), tmask.to(torch.uint8),
                           nmask, grids.long(), 4)
    for g, w_ in zip(got, _plain(bucket, 4)):
        np.testing.assert_array_equal(g.numpy(), w_)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    occ0, hubs, tgts, tmask, nmask, grids = _torch(
        random_bucket(6, GRIDS, SLOTS, 4))
    args = [occ0, hubs, tgts, tmask, nmask, grids]
    bad = {0: occ0.long(), 1: hubs[:, :-1], 3: tmask.to(torch.uint8),
           5: grids[:-1]}
    for i, x in bad.items():
        with pytest.raises(ValueError):
            tkernel.route_slots(*(x if j == i else a
                                  for j, a in enumerate(args)), 4)
    outside = hubs.clone()
    outside[2, 0] = torch.tensor([7, 0])            # grid 2 is 7 x 9
    with pytest.raises(ValueError, match="outside"):
        tkernel.route_slots(occ0, outside, tgts, tmask, nmask, grids, 4)
    with pytest.raises(ValueError, match="card"):
        tkernel.route_slots(*args, 4,
                            levels=torch.zeros(len(GRIDS), dtype=torch.int32))
