"""The arithmetic of the port's tensor-core `acim_matmul` route, on the
CPU: the exact three-term bf16 split of float32 operands, a torch model
of the kernel's sums (`acim_split_model.py`: term products per k16 step,
zero terms skipped per k-tile, the ADC at every chunk boundary, split-K
at chunk boundaries) against the plain version and the JAX reference's
Pallas kernel in interpret mode, the route table and the split factor.

Tolerances:
- The split is exact: hi + mid + lo equals the operand bit for bit.
- +-1 operands: every partial sum is an integer, exact in any order, so
  the model is bit-equal to the plain version and the Pallas kernel,
  with and without split-K (N a power of two: every ADC output is a
  multiple of a power-of-two delta, so the ranges add exactly).
- Mismatch-folded weights and float activations: the model sums a chunk
  in another order than the plain version; an ADC decision can flip
  where s / delta lies within ulps of a rounding boundary, moving that
  output by exactly delta.  Every difference must be a whole number of
  deltas, on at most 1e-3 of the outputs (the bound `chip_smoke.py`
  holds the kernel to).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.acim_spec import MacroSpec as RSpec
from repro.kernels import acim_matmul as rk
from repro_torch.core.acim_numerics import NoiseParams
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.acim_matmul import kernel as tkernel
from repro_torch.kernels.acim_matmul import ops as tops
from repro_torch.kernels.acim_matmul import ref as tref
from acim_split_model import split_terms, wgmma_route_model
from test_kernels import SHAPES
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

FLIP_SHARE = 1e-3


def _pm1(seed, shape):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5,
                    1.0, -1.0).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _three_term_values():
    """Floats whose split needs all three terms: 24 significant bits
    spread over the three bf16 pieces."""
    rng = np.random.default_rng(3)
    # top 8 bits random; the low 16 odd, in [2^14, 2^15): hi rounds down,
    # mid takes bits 14..7 and lo keeps the odd last bit
    mant = ((2 ** 23 + rng.integers(0, 2 ** 7, 64) * 2 ** 16)
            + (0x4001 | (rng.integers(0, 2 ** 16, 64) & 0x3FFE)))
    sign = np.where(rng.random(64) < 0.5, -1.0, 1.0)
    return (sign * mant * 2.0 ** -23).astype(np.float32)


def _mismatch_folded(seed, shape, n=256, b=4):
    w = _t(_pm1(seed, shape))
    eps = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        shape).astype(np.float32))
    return tops.mismatch_weights(w, MacroSpec(2 * n, shape[1], 2, b), eps,
                                 NoiseParams.from_cal())


@pytest.mark.parametrize("case", ["uniform", "pm1", "zeros", "three_terms",
                                  "mismatch"])
def test_split_sums_back_exactly(case):
    rng = np.random.default_rng(0)
    v = {"uniform": lambda: _t(rng.uniform(-2, 2, 4096).astype(np.float32)),
         "pm1": lambda: _t(_pm1(1, (4096,))),
         "zeros": lambda: torch.tensor([0.0, -0.0, 0.0, -0.0]),
         "three_terms": lambda: _t(_three_term_values()),
         "mismatch": lambda: _mismatch_folded(2, (64, 64)).reshape(-1)}[case]()
    hi, mid, lo = split_terms(v)
    for t in (hi, mid, lo):        # each term is a bf16 value
        assert torch.equal(t.to(torch.bfloat16).to(torch.float32), t)
    assert torch.equal((hi + mid) + lo, v)
    assert torch.equal(hi + (mid + lo), v)
    if case == "three_terms":
        assert bool((lo != 0).all()) and bool((mid != 0).all())
    if case in ("pm1", "zeros"):
        assert not bool(mid.any()) and not bool(lo.any())
    if case == "mismatch":
        assert bool(mid.any())


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("m,k,c,n,b", SHAPES)
def test_model_bit_equal_on_pm1(m, k, c, n, b, splits):
    """The model of the wgmma route against the plain version and the
    reference's Pallas kernel (interpret mode) on +-1 operands."""
    x, w = _pm1(m * 7 + k, (m, k)), _pm1(k * 5 + c, (k, c))
    want = np.asarray(rk.acim_matmul(jnp.asarray(x), jnp.asarray(w),
                                     RSpec(2 * n, max(c, 1), 2, b)))
    kp = -(-k // n) * n
    xp = torch.nn.functional.pad(_t(x), (0, kp - k))
    wp = torch.nn.functional.pad(_t(w), (0, 0, 0, kp - k))
    got = wgmma_route_model(xp, wp, n, b, splits=splits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tref.acim_matmul_ref(xp, wp, n=n, b_adc=b).numpy())


def _assert_whole_deltas(got, want, delta):
    steps = (got.double() - want.double()) / delta
    assert torch.allclose(steps, steps.round(), atol=1e-3)
    assert float((steps != 0).double().mean()) <= FLIP_SHARE


@pytest.mark.parametrize("x_kind", ["pm1", "float"])
@pytest.mark.parametrize("m,k,c,n,b,splits", [(64, 1024, 160, 256, 4, 2),
                                              (48, 512, 96, 128, 5, 1),
                                              (40, 192, 136, 48, 4, 1)])
def test_model_on_mismatch_weights_within_whole_deltas(m, k, c, n, b, splits,
                                                       x_kind):
    """Mismatch-folded weights, +-1 or float activations in [-1, 1] (the
    RWL pulse width): whole ADC steps apart, on <= 1e-3 of outputs."""
    w = _mismatch_folded(k + c, (k, c), n, b)
    x = (_t(_pm1(m, (m, k))) if x_kind == "pm1" else _t(
        np.random.default_rng(m).uniform(-1, 1, (m, k)).astype(np.float32)))
    got = wgmma_route_model(x, w, n, b, splits=splits)
    _assert_whole_deltas(got, tref.acim_matmul_ref(x, w, n=n, b_adc=b),
                         2.0 * n / 2 ** b)


@pytest.mark.parametrize("n,want", [(4, "mma"), (8, "mma"), (2, "mma"),
                                    (12, "cuda_core"), (24, "cuda_core"),
                                    (16, "wgmma"), (48, "wgmma"),
                                    (256, "wgmma"), (2048, "wgmma")])
def test_route(n, want):
    assert tkernel.route(n) == want


def test_split_k():
    # the trainer's FFNs on 132 SMs: wi has 192 output tiles (no split),
    # wo 48 (two CTAs share K: 96 CTAs)
    assert tkernel.split_k(1024, 3072, 768, 256, 132) == 1
    assert tkernel.split_k(1024, 768, 3072, 256, 132) == 2
    assert tkernel.split_k(128, 128, 4096, 256, 132) == 16   # 16 chunks
    assert tkernel.split_k(1024, 768, 3072, 48, 132) == 1    # delta not 2^j
    assert tkernel.split_k(1024, 768, 256, 256, 132) == 1    # one chunk


def test_wrapper_refuses_bad_operands():
    x, w = torch.ones(4, 64), torch.ones(64, 8)
    for fn in (tkernel.acim_matmul, tkernel.acim_matmul_wgmma,
               tkernel.acim_matmul_mma, tkernel.acim_matmul_cuda_core):
        with pytest.raises(ValueError, match="K % n"):
            fn(x[:, :60].contiguous(), w[:60], 32, 3)
        with pytest.raises(ValueError, match="float32"):
            fn(x.double(), w, 32, 3)
        with pytest.raises(ValueError, match="float32"):
            fn(x.t(), w[:4], 2, 1)                       # not contiguous
    with pytest.raises(ValueError, match="C % 4"):
        tkernel.acim_matmul_wgmma(x, w[:, :6].contiguous(), 32, 3)
    with pytest.raises(ValueError, match="N % 16"):
        tkernel.acim_matmul_wgmma(x, w, 8, 3)
    with pytest.raises(ValueError, match="power of two"):
        tkernel.acim_matmul_wgmma(torch.ones(4, 96), torch.ones(96, 8), 48,
                                  3, splits=2)
    with pytest.raises(ValueError, match="run on cuda"):   # no CPU mode
        tkernel.acim_matmul_wgmma(x, w, 32, 3)
    with pytest.raises(ValueError, match="run on cuda"):
        tkernel.acim_matmul_cuda_core(x, w, 32, 3)
    with pytest.raises(ValueError, match="N in"):       # other N
        tkernel.acim_matmul_mma(x, w, 16, 3)
    with pytest.raises(ValueError, match="K % 4"):
        tkernel.acim_matmul_mma(torch.ones(4, 6), torch.ones(6, 8), 2, 1)
    with pytest.raises(ValueError, match="C % 4"):
        tkernel.acim_matmul_mma(x, w[:, :6].contiguous(), 8, 3)
    with pytest.raises(ValueError, match="run on cuda"):
        tkernel.acim_matmul_mma(x, w, 8, 3)


@pytest.mark.parametrize("n", [16, 8])
def test_ops_pads_ragged_columns(n):
    """C % 4 != 0: ops pads w's columns on the wgmma route and cuts them
    off; the result equals the reference at (37, 100, 70)."""
    x, w = _pm1(37, (37, 100)), _pm1(70, (100, 70))
    n0 = dict(LAUNCHES)
    got = tops.acim_matmul(_t(x), _t(w), MacroSpec(2 * n, 70, 2, 3))
    assert got.shape == (37, 70)
    want = rk.acim_matmul(jnp.asarray(x), jnp.asarray(w), RSpec(2 * n, 70, 2, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert dict(LAUNCHES) == n0                      # no kernel on the CPU
