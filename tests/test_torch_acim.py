"""The port's ACIM numerics, `acim_matmul` family and `cim_linear` held
against the JAX reference on the CPU.

Inputs come from numpy seeds.  The JAX side runs as its own tests run it:
the Pallas kernel in interpret mode.  The port's wrapper takes its plain
version here, because the tensors lie on the CPU.

Tolerances:
- +-1 operands: every chunk sum is a small integer, exact in any order,
  so the macro outputs are bit-equal (`assert_array_equal`).
- Noisy / mismatch-folded sums are not integers, and the two frameworks
  sum a chunk in different orders; an ADC decision can then flip where
  s/delta lies within a few ulps of a rounding boundary, moving that
  output by exactly delta.  Those tests require every difference to be
  a whole number of deltas and flips on at most 0.1 % of the outputs.
- Float32 scales (mean |x|) are reduced in different orders: rtol 1e-6
  on the outputs, 1e-5 on gradients (a few roundings deeper).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acim_numerics as ran
from repro.core.acim_spec import MacroSpec as RSpec
from repro.kernels import acim_matmul as rk
from repro.quant import cim_linear as rcim
from repro_torch.core import acim_numerics as tan
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.acim_matmul import kernel as tkernel
from repro_torch.kernels.acim_matmul import ops as tops
from repro_torch.kernels.acim_matmul import ref as tref
from repro_torch.quant import cim_linear as tcim
from test_kernels import SHAPES
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)


def _pm1(seed, shape):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5,
                    1.0, -1.0).astype(np.float32)


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _assert_adc_close(got, want, delta, max_share=1e-3):
    """Equal up to ADC flips: each difference a whole number of deltas,
    on at most `max_share` of the outputs."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = got - want
    steps = diff / delta
    np.testing.assert_allclose(steps, np.round(steps), atol=1e-3)
    assert np.mean(diff != 0) <= max_share, np.mean(diff != 0)


# ---------------------------------------------------------------------------
# core.acim_numerics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,c,n,b", SHAPES)
def test_ideal_ref_bit_equal(m, k, c, n, b):
    x, w = _pm1(m * 7 + k, (m, k)), _pm1(k * 5 + c, (k, c))
    want = ran.acim_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                               RSpec(2 * n, c, 2, b))
    got = tan.acim_matmul_ref(_t(x), _t(w), MacroSpec(2 * n, c, 2, b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lead,k,c,n,b", [((2, 3), 100, 8, 32, 3),
                                          ((5,), 512, 12, 128, 6)])
def test_noisy_ref_with_jax_draws(lead, k, c, n, b):
    """The reference's noisy branch with its own draws handed over:
    jax.random.normal(instance_key, (n_chunks, n, cols)) and
    jax.random.normal(conversion_key, s.shape)."""
    spec, rspec = MacroSpec(2 * n, c, 2, b), RSpec(2 * n, c, 2, b)
    x, w = _pm1(k, (*lead, k)), _pm1(c, (k, c))
    n_chunks = -(-k // n)
    ki, kc = jax.random.key(11), jax.random.key(12)
    want = ran.acim_matmul_ref(jnp.asarray(x), jnp.asarray(w), rspec,
                               noise=ran.NoiseParams.from_cal(),
                               instance_key=ki, conversion_key=kc)
    draws = tan.NoiseDraws(
        _t(jax.random.normal(ki, (n_chunks, n, c), jnp.float32)),
        _t(jax.random.normal(kc, (*lead, n_chunks, c), jnp.float32)))
    got = tan.acim_matmul_ref(_t(x), _t(w), spec,
                              noise=tan.NoiseParams.from_cal(), draws=draws)
    _assert_adc_close(got.numpy(), want, 2.0 * n / 2 ** b)
    # the noise moved some outputs off the ideal path, and the port saw it
    ideal = tan.acim_matmul_ref(_t(x), _t(w), spec)
    assert not torch.equal(got, ideal)


def test_noisy_ref_default_draws_are_seeded():
    spec = MacroSpec(128, 8, 2, 5)
    x, w = _t(_pm1(1, (4, 128))), _t(_pm1(2, (128, 8)))
    noise = tan.NoiseParams.from_cal()
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = tan.acim_matmul_ref(x, w, spec, noise=noise, generator=g())
    b = tan.acim_matmul_ref(x, w, spec, noise=noise, generator=g())
    assert torch.equal(a, b)


def test_noise_params_and_expected_snr():
    assert tan.NoiseParams.from_cal() == tan.NoiseParams(
        **vars(ran.NoiseParams.from_cal()))
    for h, w, l, b in [(256, 64, 2, 4), (128, 128, 2, 3), (1024, 16, 8, 6)]:
        np.testing.assert_allclose(
            tan.expected_snr_db(MacroSpec(h, w, l, b)),
            ran.expected_snr_db(RSpec(h, w, l, b)), rtol=1e-6)


def test_adc_rounds_half_to_even_and_clips():
    # N = 128, B = 5: delta = 8, codes in [-16, 15]
    s = np.array([4.0, 12.0, -4.0, -12.0, 3.9, 200.0, -200.0, 0.0],
                 np.float32)
    want = ran.adc_quantize_sum(jnp.asarray(s), 128, 5)
    got = tan.adc_quantize_sum(_t(s), 128, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  [0, 16, 0, -16, 0, 120, -128, 0])


@pytest.mark.parametrize("bx,bw", [(2, 2), (3, 2), (4, 3)])
def test_multibit_ref(bx, bw):
    rng = np.random.default_rng(bx * 10 + bw)
    x = rng.integers(-2 ** (bx - 1), 2 ** (bx - 1), (5, 96)).astype(np.int32)
    w = rng.integers(-2 ** (bw - 1), 2 ** (bw - 1), (96, 7)).astype(np.int32)
    want = ran.acim_matmul_multibit_ref(jnp.asarray(x), jnp.asarray(w),
                                        RSpec(128, 7, 2, 5), bx, bw)
    got = tan.acim_matmul_multibit_ref(_t(x), _t(w), MacroSpec(128, 7, 2, 5),
                                       bx, bw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_symmetric_and_binarize(bits):
    x = _normal(bits, (33, 17))
    q_r, s_r = ran.quantize_symmetric(jnp.asarray(x), bits)
    q_t, s_t = tan.quantize_symmetric(_t(x), bits)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
    assert q_t.dtype == torch.int32
    np.testing.assert_allclose(float(s_t), float(s_r), rtol=1e-6)
    b_r, sc_r = ran.binarize(jnp.asarray(x))
    b_t, sc_t = tan.binarize(_t(x))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_r))
    np.testing.assert_allclose(float(sc_t), float(sc_r), rtol=1e-6)


# ---------------------------------------------------------------------------
# kernels.acim_matmul (on the CPU: the wrapper's plain version)
# ---------------------------------------------------------------------------
# The chunk sizes of the mma route (N 8, 4, 2; a macro has N >= 2^B).
SMALL_N_SHAPES = [(16, 64, 16, 8, 3), (7, 100, 33, 4, 2), (5, 64, 130, 2, 1)]


@pytest.mark.parametrize("m,k,c,n,b", SHAPES + SMALL_N_SHAPES)
def test_acim_matmul_bit_equal_to_jax(m, k, c, n, b):
    x, w = _pm1(m * 7 + k, (m, k)), _pm1(k * 5 + c, (k, c))
    want = rk.acim_matmul(jnp.asarray(x), jnp.asarray(w),
                          RSpec(2 * n, max(c, 1), 2, b))
    n0 = LAUNCHES["acim_matmul"]
    got = tops.acim_matmul(_t(x), _t(w), MacroSpec(2 * n, max(c, 1), 2, b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert LAUNCHES["acim_matmul"] == n0          # no kernel on the CPU
    np.testing.assert_array_equal(
        got.numpy(), tref.acim_matmul_ref(_t(x), _t(w), n=n, b_adc=b).numpy())


def test_acim_matmul_leading_dims_and_padding():
    x, w = _pm1(1, (2, 3, 100)), _pm1(2, (100, 8))
    spec = MacroSpec(128, 8, 2, 3)
    got = tops.acim_matmul(_t(x), _t(w), spec)
    assert got.shape == (2, 3, 8)
    want = rk.acim_matmul(jnp.asarray(x), jnp.asarray(w),
                          RSpec(128, 8, 2, 3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_wrapper_checks_operands():
    x, w = torch.ones(4, 64), torch.ones(64, 8)
    with pytest.raises(ValueError, match="K % n"):
        tkernel.acim_matmul(x[:, :60].contiguous(), w[:60], 32, 3)
    with pytest.raises(ValueError, match="float32"):
        tkernel.acim_matmul(x.double(), w, 32, 3)
    with pytest.raises(ValueError, match="float32"):
        tkernel.acim_matmul(x.t(), w[:4], 2, 1)          # not contiguous


def test_ste_gradients_match_jax():
    spec, rspec = MacroSpec(128, 16, 2, 4), RSpec(128, 16, 2, 4)
    x, w = _pm1(5, (2, 4, 100)), _pm1(6, (100, 16))
    r = _normal(7, (2, 4, 16))
    gx_r, gw_r = jax.grad(
        lambda x, w: jnp.sum(rk.acim_matmul_ste(x, w, rspec) * r),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    torch.sum(tops.acim_matmul_ste(xt, wt, spec) * _t(r)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_r), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_r), rtol=1e-5,
                               atol=1e-6)


def test_mismatch_weights_match_jax():
    spec, rspec = MacroSpec(128, 16, 2, 6), RSpec(128, 16, 2, 6)
    w = _pm1(8, (64, 16))
    key = jax.random.key(0)
    want = rk.mismatch_weights(jnp.asarray(w), rspec, key,
                               ran.NoiseParams.from_cal())
    eps = _t(jax.random.normal(key, w.shape, jnp.float32))
    got = tops.mismatch_weights(_t(w), spec, eps, tan.NoiseParams.from_cal())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# quant.cim_linear
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mismatch", [False, True])
def test_cim_linear_forward_and_gradients(mismatch):
    spec, rspec = MacroSpec(64, 48, 2, 4), RSpec(64, 48, 2, 4)
    x, w = _normal(1, (3, 5, 96)), _normal(2, (96, 48), 0.1)
    r = _normal(3, (3, 5, 48))
    rcfg = rcim.CIMConfig(rspec, mismatch=mismatch, instance_seed=4)
    tcfg = tcim.CIMConfig(spec, mismatch=mismatch, instance_seed=4)
    eps = _t(jax.random.normal(jax.random.key(4), w.shape, jnp.float32))

    y_r, vjp = jax.vjp(lambda x, w: rcim.cim_linear(x, w, rcfg),
                       jnp.asarray(x), jnp.asarray(w))
    gx_r, gw_r = vjp(jnp.asarray(r))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y_t = tcim.cim_linear(xt, wt, tcfg, eps=eps)
    torch.sum(y_t * _t(r)).backward()

    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_r),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_r), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_r), rtol=1e-5,
                               atol=1e-6)


def test_cim_linear_digital_path_and_default_draw():
    x, w = _t(_normal(1, (4, 64))), _t(_normal(2, (64, 8)))
    torch.testing.assert_close(tcim.cim_linear(x, w, None), x @ w)
    cfg = tcim.CIMConfig(MacroSpec(64, 8, 2, 4), instance_seed=9)
    a = tcim.cim_linear(x, w, cfg)
    eps = tcim.mismatch_eps(9, (64, 8), torch.device("cpu"))
    assert eps is tcim.mismatch_eps(9, (64, 8), torch.device("cpu"))
    assert torch.equal(a, tcim.cim_linear(x, w, cfg, eps=eps.clone()))
    assert not torch.equal(
        a, tcim.cim_linear(x, w, tcim.CIMConfig(cfg.spec, mismatch=False)))
