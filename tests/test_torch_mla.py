"""The port's MLA (DeepSeek-V2 latent attention, `models/attention.py`)
and the flash attention plain version at separate q/k and v head dims
held against the JAX reference on the CPU, on the reduced deepseek-v2-lite
(d 64, 4 heads, kv_lora 32, nope 16, rope 8, v 16) and at MLA's full
head dims (q/k 192, v 128).

Parameters come from the reference's `init_mla` and are carried over by
`convert.lm_params_from_numpy`; activations are drawn with numpy.
Tolerances:

- `mla_fwd`, float32: atol = rtol = 1e-5 (measured <= 7.8e-7); bf16:
  rel L2 <= 1e-2 (measured 0: the same bits).
- `mla_decode`, step by step over 12 tokens at batch 2: float32 outputs
  atol = rtol = 1e-5 (measured <= 4.8e-7) and caches atol = rtol = 1e-6
  (measured <= 1.2e-6 abs at |c| > 1); bf16 outputs rel L2 <= 1e-2
  (measured <= 1.9e-3), caches within one bf16 ulp.
- `mla_fwd_blockwise` (bf16; the tensor-core route's plain version on
  the CPU), on the reduced config widened to the full config's MLA head
  dims (q/k 192, v 128: the kernel's pair), against the reference's:
  the reference rounds scores and P.V to bf16, the port does not: rel
  L2 <= 1e-2 (measured 3.8e-3).  No route takes float32, or the reduced
  config's own (nope + rope, v) = (24, 16): they raise.
- The plain version at (192, 128) against the reference's
  `_blockwise_core` on v padded to 192 with the padding sliced off: bf16
  rel L2 <= 5e-3 (measured <= 3.9e-3), max abs <= 0.02 (measured <=
  0.0156); the padded columns contribute nothing: the plain version on
  padded v equals it on v, bit for bit, in its first 128 columns.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import attention as rattn
from repro.models import common as rcommon
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import flash_attention_tc_ref
from repro_torch.models import attention as tattn
from repro_torch.models.common import causal_mask
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

NAME = "deepseek_v2_lite_16b"
SEQ, BATCH, STEPS, MAX_SEQ = 80, 2, 12, 16
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def wide(cfg):
    """The reduced config with the full config's MLA head dims (q/k 192, v
    128; kv_lora 32): the blockwise prefill runs on a kernel route only,
    and the reduced (nope + rope, v) = (24, 16) has none."""
    return dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, rope_dim=64, nope_dim=128, v_dim=128))


def _models(rcfg, tcfg):
    rp = rattn.init_mla(jax.random.key(0), rcfg)
    scale = 1.0 + 0.2 * np.random.default_rng(7).standard_normal(
        rcfg.mla.kv_lora).astype(np.float32)
    rp = dict(rp, kv_norm={"scale": jnp.asarray(scale)})
    mod = tattn.init_mla(tcfg, torch.Generator())
    mod.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    return rcfg, tcfg, rp, mod.requires_grad_(False)


@pytest.fixture(scope="module")
def mla():
    """(reference cfg, port cfg, reference params, port `MLA`) of the
    reduced config, with a non-trivial `kv_norm` scale."""
    return _models(rregistry.reduced(NAME), registry.reduced(NAME))


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_fwd_matches_jax(mla, dtype):
    rcfg, tcfg, rp, mod = mla
    tdt, jdt = DTYPES[dtype]
    x = _x(rcfg, (BATCH, SEQ))
    want = rattn.mla_fwd(rp, jnp.asarray(x, jdt), rcfg,
                         mask=rcommon.causal_mask(SEQ),
                         positions=jnp.arange(SEQ))
    got = tattn.mla_fwd(mod, torch.from_numpy(x).to(tdt), tcfg,
                        mask=causal_mask(SEQ), positions=torch.arange(SEQ))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert _rel_l2(got, want) <= 1e-2


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_decode_matches_jax(mla, dtype):
    rcfg, tcfg, rp, mod = mla
    tdt, jdt = DTYPES[dtype]
    rcache = rattn.init_mla_cache(rcfg, BATCH, MAX_SEQ, dtype=jdt)
    tcache = tattn.init_mla_cache(tcfg, BATCH, MAX_SEQ, dtype=tdt,
                                  device="cpu")
    rng = np.random.default_rng(4)
    for t in range(STEPS):
        x = rng.standard_normal((BATCH, rcfg.d_model)).astype(np.float32)
        want, rcache = rattn.mla_decode(rp, jnp.asarray(x, jdt), rcache,
                                        jnp.int32(t), rcfg)
        got, tcache = tattn.mla_decode(mod, torch.from_numpy(x).to(tdt),
                                       tcache, t, tcfg)
        want, got = np.asarray(want.astype(jnp.float32)), got.float().numpy()
        for k in ("c_kv", "k_rope"):
            rc = np.asarray(rcache[k].astype(jnp.float32))
            tc = tcache[k].float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(tc, rc, atol=1e-6, rtol=1e-6)
            else:
                ulp = np.spacing(np.abs(rc).astype(jnp.bfloat16)).astype(
                    np.float32)
                assert (np.abs(tc - rc) <= ulp).all(), (t, k)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            assert _rel_l2(got, want) <= 1e-2, t


def test_init_mla_cache_shapes(mla):
    rcfg, tcfg, _, _ = mla
    for cfg, rc in ((tcfg, rcfg), (registry.get(NAME), rregistry.get(NAME))):
        want = rattn.init_mla_cache(rc, 3, 40)
        got = tattn.init_mla_cache(cfg, 3, 40, device="cpu")
        assert set(got) == set(want) == {"c_kv", "k_rope"}
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert got[k].dtype == torch.bfloat16 and not got[k].any()


def test_mla_fwd_blockwise_matches_jax(mla):
    rcfg, tcfg, rp, mod = _models(wide(rregistry.reduced(NAME)),
                                  wide(registry.reduced(NAME)))
    x = _x(rcfg, (BATCH, SEQ), seed=3)
    want = rattn.mla_fwd_blockwise(rp, jnp.asarray(x, jnp.bfloat16), rcfg,
                                   positions=jnp.arange(SEQ), kv_block=32)
    got = tattn.mla_fwd_blockwise(mod, torch.from_numpy(x).bfloat16(), tcfg,
                                  positions=torch.arange(SEQ), kv_block=32)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got.float().numpy(),
                   np.asarray(want.astype(jnp.float32))) <= 1e-2
    # float32 at (192, 128), and the reduced (24, 16) in any dtype: no
    # route takes them
    with pytest.raises(ValueError, match="head dims"):
        tattn.mla_fwd_blockwise(mod, torch.from_numpy(x), tcfg,
                                positions=torch.arange(SEQ))
    _, tcfg, _, mod = mla
    with pytest.raises(ValueError, match="head dims"):
        tattn.mla_fwd_blockwise(mod, torch.from_numpy(x).bfloat16(), tcfg,
                                positions=torch.arange(SEQ))


def _qkv(seed, b, s, h, dh, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh)).astype(np.float32),
            rng.standard_normal((b, s, h, dh)).astype(np.float32),
            rng.standard_normal((b, s, h, dv)).astype(np.float32))


@pytest.mark.parametrize("s", [129, 300])
def test_plain_192_128_matches_padded_core(s):
    """MLA's full head dims through the route the prefill takes: bf16 at
    (192, 128) runs the tensor-core route's plain version on the CPU,
    held against the reference's jnp core on v padded to 192."""
    b, h, dh, dv = 1, 4, 192, 128
    q, k, v = _qkv(s, b, s, h, dh, dv)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    vpad = jnp.pad(jv, ((0, 0), (0, 0), (0, 0), (0, dh - dv)))
    want = rattn._blockwise_core(jq[:, :, :, None, :], jk, vpad, kv_block=128,
                                 prefix_len=0, out_dtype=jnp.bfloat16)
    want = np.asarray(want[:, :, :, 0, :dv].astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    assert tkernel.route(torch.bfloat16, dh, dv) == "wgmma"
    got = tops.flash_attention(tq, tk, tv)
    assert tuple(got.shape) == (b, s, h, dv) and got.dtype == torch.bfloat16
    assert torch.equal(got, flash_attention_tc_ref(tq, tk, tv))
    got = got.float().numpy()
    assert _rel_l2(got, want) <= 5e-3
    assert np.abs(got - want).max() <= 0.02
    padded = flash_attention_tc_ref(
        tq, tk, torch.nn.functional.pad(tv, (0, dh - dv)))
    assert torch.equal(padded[..., :dv], flash_attention_tc_ref(tq, tk, tv))
    assert not padded[..., dv:].any()


def test_routes_of_head_dim_pairs():
    """The tensor-core route takes bf16 at (64, 64), (128, 128), (192,
    128) and (256, 256); any other pair, or float32 at (192, 128), raises
    with the pairs it supports, on the CPU as on the card."""
    bf16 = torch.bfloat16
    assert tkernel.TC_DIM_PAIRS == ((64, 64), (128, 128), (192, 128),
                                    (256, 256), (80, 80))
    assert tkernel.route(bf16, 192, 128) == "wgmma"
    assert tkernel.route(bf16, 128) == tkernel.route(bf16, 128, 128) == "wgmma"
    for dh, dv, dtype in ((192, 128, torch.float32), (192, 192, bf16),
                          (128, 64, bf16), (256, 128, bf16)):
        assert tkernel.route(dtype, dh, dv) == "tf32x3"
        z = [torch.zeros((1, 8, 2, d), dtype=dtype) for d in (dh, dh, dv)]
        with pytest.raises(ValueError, match="head dims"):
            tops.flash_attention(*z)
    z = torch.zeros((1, 8, 2, 192), dtype=bf16)
    with pytest.raises(ValueError, match="head dims"):
        tkernel.flash_attention_wgmma(z, z, z[..., :64])
    with pytest.raises(ValueError, match="dtype"):
        tkernel.flash_attention_wgmma(z.float(), z.float(),
                                      z[..., :128].float())
    with pytest.raises(ValueError, match="must be"):
        tkernel.flash_attention_wgmma(z, z, torch.zeros((1, 9, 2, 128),
                                                        dtype=bf16))
    out, p = tkernel.flash_attention_wgmma_p(z, z, z[..., :128])
    assert tuple(out.shape) == (1, 8, 2, 128) and tuple(p.shape) == (1, 2, 8, 8)


def test_mla_full_dims_take_the_tensor_core_route():
    """At deepseek-v2-lite's MLA dims the blockwise prefill's q / k are
    192 wide and v 128: one wgmma-route call (its plain version on the
    CPU) per layer."""
    cfg = registry.get(NAME)
    m = cfg.mla
    assert (m.nope_dim + m.rope_dim, m.v_dim) == (192, 128)
    assert tkernel.route(torch.bfloat16, m.nope_dim + m.rope_dim,
                         m.v_dim) == "wgmma"
    small = dataclasses.replace(registry.reduced(NAME), mla=m, n_heads=2)
    mod = tattn.init_mla(small, torch.Generator().manual_seed(0)).bfloat16()
    x = torch.from_numpy(_x(small, (1, 40))).bfloat16()
    with torch.no_grad():
        got = tattn.mla_fwd_blockwise(mod, x, small,
                                      positions=torch.arange(40))
        want = tattn.mla_fwd(mod, x, small, mask=causal_mask(40),
                             positions=torch.arange(40))
    assert _rel_l2(got.float().numpy(), want.float().numpy()) <= 2e-2
