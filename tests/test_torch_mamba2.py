"""The port's Mamba2 mixer (`models/mamba2.py`) held against the JAX
reference on the CPU.

Model: `zamba2-reduced`'s mixer (d 64, expand 2: d_inner 128, 8 heads of
16, state 8, one B/C group, conv 4, chunk 16).  Parameters come from the
reference's `init_mamba2` with every leaf moved off its initial value by
numpy draws (so `conv_b`, `dt_bias`, `d_skip` and the norm scale
matter), carried over as numpy arrays; inputs are numpy draws.
Tolerances:

- `mamba2_fwd` in float32 at seq = chunk, 3 chunks and seq < chunk:
  rtol 1e-5, atol 1e-5 (summation order only: the port sums C B^T once
  per group and pairs the three-operand einsums its own way; measured
  max abs <= 2.4e-6 on outputs of O(1)).
- `mamba2_fwd` in bf16: rel L2 <= 2e-2 (both round every product and
  sum to bf16, at other places: XLA keeps some fused elementwise chains
  in float32; measured <= 6.0e-3).
- `mamba2_decode` step by step: float32 rtol 1e-5, atol 1e-5 (outputs
  and both states); bf16 outputs rel L2 <= 2e-2, states rel L2 <= 1e-2
  (float32 states updated from bf16 products).
- The port's chunked form against its own recurrence, the reference's
  identity (`tests/test_models.py::test_mamba2_chunked_equals_recurrent`):
  atol 2e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import mamba2 as rmamba
from repro_torch.configs import registry
from repro_torch.models import mamba2 as tmamba

NAME = "zamba2_2_7b"


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _load(module, tree: dict) -> None:
    """Copy a reference leaf dict into `module`'s parameters."""
    sd = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sd.update({f"{k}.{kk}": torch.from_numpy(np.array(vv))
                       for kk, vv in v.items()})
        else:
            sd[k] = torch.from_numpy(np.array(v))
    module.load_state_dict(sd, strict=True)


@pytest.fixture(scope="module")
def mixer():
    """(cfg, reference params, port module): the leaves off their
    initial values."""
    rcfg = rregistry.reduced(NAME)
    tcfg = registry.reduced(NAME)
    rp = rmamba.init_mamba2(jax.random.key(1), rcfg)
    rng = np.random.default_rng(4)
    rp = jax.tree.map(lambda a: a + jnp.asarray(
        0.1 * rng.standard_normal(a.shape).astype(np.float32)), rp)
    mod = tmamba.Mamba2(tcfg, torch.Generator().manual_seed(0))
    _load(mod, jax.tree.map(np.asarray, rp))
    return rcfg, tcfg, rp, mod


def _bf16(rp, mod):
    """Both parameter sets in bf16: the serving cast of a layer's leaves,
    which the stacked tree gives every Mamba2 leaf."""
    return (jax.tree.map(lambda a: a.astype(jnp.bfloat16), rp),
            copy.deepcopy(mod).to(torch.bfloat16))


def test_dims_and_leaf_names(mixer):
    rcfg, tcfg, rp, mod = mixer
    assert tmamba.dims(tcfg) == rmamba.dims(rcfg) == (128, 8)
    want = {"in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
            "norm.scale", "out_proj"}
    assert set(mod.state_dict()) == want
    for k, v in mod.state_dict().items():
        leaf = rp
        for part in k.split("."):
            leaf = leaf[part]
        assert tuple(v.shape) == leaf.shape, k


@pytest.mark.parametrize("seq", [16, 48, 10], ids=["chunk", "3chunks",
                                                    "below_chunk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_fwd_matches_jax(mixer, seq, dtype):
    rcfg, tcfg, rp, mod = mixer
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, rcfg.d_model)).astype(np.float32)
    if dtype == "float32":
        want = np.asarray(rmamba.mamba2_fwd(rp, jnp.asarray(x), rcfg))
        with torch.no_grad():
            got = tmamba.mamba2_fwd(mod, torch.from_numpy(x), tcfg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    rt, tm = _bf16(rp, mod)
    want = np.asarray(rmamba.mamba2_fwd(
        rt, jnp.asarray(x).astype(jnp.bfloat16), rcfg).astype(jnp.float32))
    with torch.no_grad():
        got = tmamba.mamba2_fwd(tm, torch.from_numpy(x).bfloat16(), tcfg)
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got.float().numpy(), want) <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_jax(mixer, dtype):
    """Step by step from the zero state over 20 tokens: outputs and both
    states (`ssm` (B, H, N, P), `conv` (B, K - 1, C), float32)."""
    rcfg, tcfg, rp, mod = mixer
    f32 = dtype == "float32"
    rt, tm = (rp, mod) if f32 else _bf16(rp, mod)
    x = np.random.default_rng(9).standard_normal(
        (3, 20, rcfg.d_model)).astype(np.float32)
    rst = rmamba.init_mamba2_state(rcfg, 3)
    tst = tmamba.init_mamba2_state(tcfg, 3, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tst.items()} == {
        "ssm": ((3, 8, 8, 16), torch.float32),
        "conv": ((3, 3, 128 + 16), torch.float32)}
    jdt = jnp.float32 if f32 else jnp.bfloat16
    step = jax.jit(lambda p, x_, s: rmamba.mamba2_decode(p, x_, s, rcfg))
    for t in range(x.shape[1]):
        want, rst = step(rt, jnp.asarray(x[:, t]).astype(jdt), rst)
        with torch.no_grad():
            got, tst = tmamba.mamba2_decode(
                tm, torch.from_numpy(x[:, t]).to(
                    torch.float32 if f32 else torch.bfloat16), tst, tcfg)
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        if f32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert _rel_l2(got, want) <= 2e-2, t
        for k in ("ssm", "conv"):
            assert tst[k].dtype == torch.float32
            if f32:
                np.testing.assert_allclose(tst[k].numpy(),
                                           np.asarray(rst[k]), rtol=1e-5,
                                           atol=1e-5)
            else:
                assert _rel_l2(tst[k].numpy(), np.asarray(rst[k])) <= 1e-2


def test_chunked_equals_recurrent(mixer):
    """The reference's identity on the port: `mamba2_fwd` over 32 tokens
    (2 chunks) equals `mamba2_decode` token by token, float32."""
    _, tcfg, _, mod = mixer
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32))
    with torch.no_grad():
        y_par = tmamba.mamba2_fwd(mod, x, tcfg)
        st = tmamba.init_mamba2_state(tcfg, 2, device="cpu")
        ys = []
        for t in range(32):
            yt, st = tmamba.mamba2_decode(mod, x[:, t], st, tcfg)
            ys.append(yt)
    np.testing.assert_allclose(y_par.numpy(), torch.stack(ys, 1).numpy(),
                               atol=2e-5)


def test_seq_not_a_multiple_of_the_chunk_raises(mixer):
    _, tcfg, _, mod = mixer
    with pytest.raises(ValueError, match="40 is not a multiple of the "
                                         "chunk 16"):
        tmamba.mamba2_fwd(mod, torch.zeros((1, 40, tcfg.d_model)), tcfg)


def test_split_and_helpers_match_jax(mixer):
    """`_split_proj`, `_causal_conv` and `_gated_rmsnorm` on the same
    inputs (float32); softplus is `jax.nn.softplus`'s form."""
    rcfg, tcfg, rp, mod = mixer
    rng = np.random.default_rng(3)
    proj = rng.standard_normal((2, 5, 2 * 128 + 16 + 8)).astype(np.float32)
    for a, b in zip(tmamba._split_proj(torch.from_numpy(proj), tcfg),
                    rmamba._split_proj(jnp.asarray(proj), rcfg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = rng.standard_normal((2, 7, 144)).astype(np.float32)
    np.testing.assert_allclose(
        tmamba._causal_conv(torch.from_numpy(x), mod.conv_w.detach(),
                            mod.conv_b.detach()).numpy(),
        np.asarray(rmamba._causal_conv(jnp.asarray(x), rp["conv_w"],
                                       rp["conv_b"])), rtol=1e-6, atol=1e-6)
    y, z = (rng.standard_normal((2, 7, 128)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        tmamba._gated_rmsnorm(mod.norm, torch.from_numpy(y),
                              torch.from_numpy(z)).detach().numpy(),
        np.asarray(rmamba._gated_rmsnorm(rp["norm"], jnp.asarray(y),
                                         jnp.asarray(z))),
        rtol=1e-5, atol=1e-6)
    v = np.linspace(-30, 30, 101).astype(np.float32)
    np.testing.assert_allclose(tmamba._softplus(torch.from_numpy(v)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-7)
