"""The arithmetic of the port's mma `acim_matmul` route (N 2, 4 and 8), on
the CPU: the k8 fragment's lanes and the per-N chunk masks, the
magic-constant ADC against `torch.round` and the plain ADC (for every
float32 chunk sum), the macros that join the hi product apart, the zero
chunks of K tails, and the torch model of the kernel's sums
(`acim_mma_model.py`: term products chained smallest first per chunk,
zero terms skipped per k-tile, integer codes, split-K in whole k-tiles)
against the plain version.

Tolerances:
- The masks, the rint and the codes are exact: equality.
- +-1 operands: every chunk sum is a small integer, exact in any order,
  so the model is bit-equal to the plain version, with and without
  split-K (N a power of two: every ADC output is a multiple of a
  power-of-two delta, so the ranges add exactly).
- Mismatch-folded weights, +-1 or float activations: the model sums a
  chunk in another order than the plain version; an ADC decision can
  flip where s / delta lies within ulps of a rounding boundary, moving
  that output by exactly delta.  Every difference must be a whole number
  of deltas, on at most 1e-3 of the outputs (the bound `chip_smoke.py`
  holds the kernel to).
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import acim_numerics
from repro_torch.core.acim_numerics import NoiseParams
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.kernels.acim_matmul import ops as tops
from repro_torch.kernels.acim_matmul import ref as tref
from acim_mma_model import (K_STEP, K_TILE, LANES, MMA_N, adc_ucode,
                            adc_value, apart, chunk_lanes, lane_ks,
                            lane_mask, magic_rint, mma_route_model, pm1,
                            term_order)
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

FLIP_SHARE = 1e-3
# test_torch_acim.py's kinds of shapes at the chunk sizes of the route
# (a macro has N >= 2^B): square, ragged M / K / C, a long K, one row
# and column, K below N, M past one tile.
SMALL_N_SHAPES = [(16, 64, 16, 8, 3), (7, 100, 33, 4, 2),
                  (128, 512, 64, 8, 3), (1, 64, 1, 2, 1),
                  (4, 1000, 20, 4, 2), (5, 64, 130, 2, 1),
                  (2, 3, 2, 4, 2), (130, 40, 70, 2, 1)]


@pytest.mark.parametrize("n", MMA_N)
def test_masks_cover_each_k_of_a_chunk_once(n):
    """Every k of a k8 step lies in exactly one chunk's lanes, and that
    chunk is k // N; the masks of a step add up to all ones."""
    for k in range(K_STEP):
        owners = [q for q in range(K_STEP // n)
                  for t in chunk_lanes(n, q) if k in lane_ks(t)]
        assert owners == [k // n], (k, owners)
    total = sum(lane_mask(n, q) for q in range(K_STEP // n))
    assert torch.equal(total, torch.ones(K_STEP))
    for q in range(K_STEP // n):
        held = torch.nonzero(lane_mask(n, q)).flatten().tolist()
        assert held == list(range(q * n, (q + 1) * n))
    assert sorted(k for t in range(LANES) for k in lane_ks(t)) == list(
        range(K_STEP))


@pytest.mark.parametrize("v", [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, -0.0,
                               0.0, 2 ** 21 + 0.5, -(2 ** 21) - 0.5,
                               0.49999997, -0.49999997, 7.0, -7.0])
def test_magic_rint_ties_and_negatives(v):
    got = magic_rint(torch.tensor([v], dtype=torch.float32))
    want = torch.round(torch.tensor([v], dtype=torch.float32))
    assert torch.equal(got, want + 0.0), (v, got, want)   # -0 rounds to +0


@settings(max_examples=300, deadline=None)
@given(st.floats(-(2.0 ** 21), 2.0 ** 21, width=32, allow_nan=False))
def test_magic_rint_equals_round(v):
    t = torch.tensor([v], dtype=torch.float32)
    assert float(magic_rint(t)) == float(torch.round(t))


@settings(max_examples=300, deadline=None)
@given(st.sampled_from(MMA_N), st.integers(1, 8),
       st.floats(-1.5, 1.5, width=32, allow_nan=False))
def test_adc_codes_equal_the_plain_adc(n, b, frac):
    """Clamped codes at and past both edges, ties included: the kernel's
    integer ADC equals `adc_quantize_sum` for s across +-1.5 N."""
    s = torch.tensor([frac * n], dtype=torch.float32)
    want = acim_numerics.adc_quantize_sum(s, n, b)
    assert float(adc_value(s, n, b)) == float(want)


@settings(max_examples=300, deadline=None)
@given(st.sampled_from(MMA_N), st.integers(1, 16),
       st.floats(width=32, allow_nan=False))
def test_adc_codes_equal_the_plain_adc_for_any_float(n, b, s):
    """Any float32 chunk sum, infinities included: the saturating FFMA
    keeps q's bits in [0, 2^30], so the int32 code never wraps."""
    t = torch.tensor([s], dtype=torch.float32)
    assert float(adc_value(t, n, b)) == float(
        acim_numerics.adc_quantize_sum(t, n, b))


@pytest.mark.parametrize("n", MMA_N)
@pytest.mark.parametrize("b", [1, 2, 3, 8])
def test_adc_codes_at_the_clamp_edges(n, b):
    """The edges of the clamp, and chunk sums far past them: s / delta
    between -3 * 2^23 and -1.5 * 2^23 (where an unsaturated magic-constant
    FFMA gives a small negative q, whose bits overflow int32 once
    offset), at +-2^22 (the end of the exact rint) and infinite."""
    delta = 2.0 * n / 2 ** b
    half = 2 ** (b - 1)
    s = torch.tensor([-2.0 * n, -n, -half * delta, -(half + 0.5) * delta,
                      (half - 1) * delta, (half - 0.5) * delta, n, 2.0 * n,
                      1e6, -1e6, -2.0 ** 24 * delta, -2.5 * 2 ** 23 * delta,
                      -1.5 * 2 ** 23 * delta, 2.0 ** 22 * delta,
                      -(2.0 ** 22) * delta, 3e38, -3e38, math.inf,
                      -math.inf], dtype=torch.float32)
    assert torch.equal(adc_value(s, n, b),
                       acim_numerics.adc_quantize_sum(s, n, b))
    u = adc_ucode(s, n, b)
    assert int(u.min()) >= 0 and int(u.max()) <= 2 ** b - 1


@pytest.mark.parametrize("n", MMA_N)
@pytest.mark.parametrize("b", range(1, 9))
def test_hi_apart_where_pm1_sums_meet_a_boundary(n, b):
    """The kernel joins the hi product by an add of its own exactly at the
    macros where a +-1 chunk sum (N - 2j) lies half a step between two
    codes that the clamp keeps apart."""
    delta = 2.0 * n / 2 ** b
    lo, hi = -(2 ** (b - 1)), 2 ** (b - 1) - 1

    def code(v):
        return max(lo, min(hi, v))

    on = any(v % 1 == 0.5 and code(math.floor(v)) != code(math.ceil(v))
             for v in (s / delta for s in range(-n, n + 1, 2)))
    assert apart(n, b) == on


@pytest.mark.parametrize("n,b", [(2, 1), (4, 1), (4, 2), (8, 1), (8, 3)])
def test_zero_chunks_add_zero(n, b):
    """A chunk of zeros (K padded to 4 or to a whole k-tile) adds its
    offset 2^(B-1), which the epilogue takes off: exactly 0."""
    assert torch.equal(adc_ucode(torch.zeros(5), n, b),
                       torch.full((5,), 2 ** (b - 1), dtype=torch.int64))
    assert torch.equal(adc_value(torch.tensor([0.0, -0.0]), n, b),
                       torch.zeros(2))
    x, w = pm1(n, (9, 2 * n)), pm1(n + 1, (2 * n, 12))
    want = tref.acim_matmul_ref(x, w, n=n, b_adc=b)
    got = mma_route_model(x, w, n, b)          # 2 chunks, 30 - 2N of zeros
    assert torch.equal(got, want)
    xp = torch.nn.functional.pad(x, (0, K_TILE))   # a whole zero k-tile
    wp = torch.nn.functional.pad(w, (0, 0, 0, K_TILE))
    assert torch.equal(mma_route_model(xp, wp, n, b), want)


def test_term_order_smallest_first():
    assert term_order(1, 1) == [(0, 0)]
    assert term_order(1, 3) == [(0, 2), (0, 1), (0, 0)]
    assert term_order(3, 3)[0] == (2, 2) and term_order(3, 3)[-1] == (0, 0)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("m,k,c,n,b", SMALL_N_SHAPES)
def test_model_bit_equal_on_pm1(m, k, c, n, b, splits):
    """The model of the mma route against the plain version on +-1
    operands, K padded as `ops` pads it (to N and to 4)."""
    x, w = pm1(m * 7 + k, (m, k)), pm1(k * 5 + c, (k, c))
    kp = -(-k // max(n, 4)) * max(n, 4)
    xp = torch.nn.functional.pad(x, (0, kp - k))
    wp = torch.nn.functional.pad(w, (0, 0, 0, kp - k))
    got = mma_route_model(xp, wp, n, b, splits=splits)
    want = tref.acim_matmul_ref(x, w, n=n, b_adc=b)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), tops.acim_matmul(x, w, MacroSpec(2 * n, c, 2, b)).numpy())


def _mismatch_folded(seed, shape, n, b):
    w = pm1(seed, shape)
    eps = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        shape).astype(np.float32))
    return tops.mismatch_weights(w, MacroSpec(2 * n, shape[1], 2, b), eps,
                                 NoiseParams.from_cal())


@pytest.mark.parametrize("x_kind", ["pm1", "float"])
@pytest.mark.parametrize("m,k,c,n,b,splits", [(64, 256, 80, 8, 3, 2),
                                              (48, 200, 64, 4, 2, 1),
                                              (40, 96, 136, 2, 1, 1),
                                              (33, 128, 20, 8, 2, 1),
                                              (64, 256, 80, 8, 1, 2),
                                              (48, 200, 64, 4, 1, 1)])
def test_model_on_mismatch_weights_within_whole_deltas(m, k, c, n, b, splits,
                                                       x_kind):
    """Mismatch-folded weights, +-1 or float activations in [-1, 1] (the
    RWL pulse width): whole ADC steps apart, on <= 1e-3 of outputs."""
    w = _mismatch_folded(k + c, (k, c), n, b)
    x = (pm1(m, (m, k)) if x_kind == "pm1" else torch.from_numpy(
        np.random.default_rng(m).uniform(-1, 1, (m, k)).astype(np.float32)))
    got = mma_route_model(x, w, n, b, splits=splits)
    want = tref.acim_matmul_ref(x, w, n=n, b_adc=b)
    steps = (got.double() - want.double()) / (2.0 * n / 2 ** b)
    assert torch.allclose(steps, steps.round(), atol=1e-3)
    assert float((steps != 0).double().mean()) <= FLIP_SHARE
