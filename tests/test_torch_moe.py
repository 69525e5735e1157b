"""The port's MoE (`models/mlp.py`'s MoE half) and its expert-parallel
all-to-all (`parallel/moe_a2a.py`) held against the JAX reference on the
CPU, on the reduced deepseek-v2-lite (8 experts, top-2, one shared
expert, group 64) and arctic (8 experts, top-2, a dense residual FFN,
group 64) configurations.

Parameters come from the reference's `init_moe` and are carried over by
`convert.lm_params_from_numpy`; inputs are drawn with numpy.
Tolerances:

- `router_probs` in float32: `top_i` bit-equal, also on a zero router
  (every probability equal: the lower index first, as `lax.top_k`).
  The logits differ from XLA's by float32 summation order (the product
  of x and the router sums in another order; measured <= 7.2e-7 abs),
  so `top_p` and the probabilities are held at rtol 2e-6 (measured <=
  6.2e-7), not bit for bit.
- `moe_fwd` in float32: claim slots and `keep` bit-equal to the
  reference's (recomputed here with its own jnp lines); gates rtol 2e-6
  as `top_p` (measured <= 3.2e-7); y and aux at rtol 1e-5, atol 1e-6
  (measured y <= 1.6e-7 abs, aux <= 1.3e-7 rel).  bf16: y rel L2 <=
  1e-2 (measured <= 5.1e-3), aux rtol 1e-3 (measured <= 6.3e-8).
- `moe_fwd_dense_eval` alike (measured float32 <= 1.1e-6 abs, bf16 rel
  L2 <= 5.2e-3).
- A zero router's aux (measured 1.43e-2 against the bound 3 x 0.01)
  equals the reference's at rtol 1e-6 (measured 6.5e-8).
- `moe_fwd_a2a` on 1, 2 and 4 CPU positions at the reference test's
  capacity (512, no drop): equal to `moe_fwd_dense_eval` within the
  reference test's atol = rtol = 2e-3 and abs 5e-6 (measured <= 1.5e-8
  in float32), and bit-equal across position counts.  Against the
  reference's own `moe_fwd_a2a` on a forced-host mesh (slow, a
  subprocess): rtol 1e-5, atol 1e-6, the same rows dropped.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import mlp as rmlp
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import mlp as tmlp
from repro_torch.parallel.moe_a2a import moe_fwd_a2a
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

REPO = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("deepseek_v2_lite_16b", "arctic_480b")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _moe(name, key=0, zero_router=False):
    """(reference cfg, port cfg, reference params, port `MoE`)."""
    rcfg, tcfg = rregistry.reduced(name), registry.reduced(name)
    rp = rmlp.init_moe(jax.random.key(key), rcfg.d_model, rcfg)
    if zero_router:
        rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    mod = tmlp.init_moe(tcfg.d_model, tcfg, torch.Generator())
    mod.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    return rcfg, tcfg, rp, mod.requires_grad_(False)


def _x(cfg, shape=(2, 64), seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,))).astype(np.float32)


def _ref_route(rp, xg, m):
    """The reference's slot, keep and gate (`src/repro/models/mlp.py`,
    `moe_fwd`'s lines), from its own `router_probs`."""
    g, gs, _ = xg.shape
    _, _, top_p, top_i = rmlp.router_probs(rp, xg, m)
    claims = jax.nn.one_hot(top_i, m.n_experts, dtype=jnp.float32)
    flat = claims.reshape(g, gs * m.top_k, m.n_experts)
    pos_in_e = jnp.cumsum(flat, axis=1) - flat
    slot = jnp.einsum("gte,gte->gt", pos_in_e, flat).reshape(g, gs, m.top_k)
    keep = (slot < rmlp.moe_capacity(m)).astype(jnp.float32)
    return [np.asarray(a) for a in (slot, keep, top_p * keep)]


@pytest.mark.parametrize("name", NAMES)
def test_moe_capacity_matches_jax(name):
    for get in ("get", "reduced"):
        rm, tm = getattr(rregistry, get)(name).moe, getattr(
            registry, get)(name).moe
        assert tmlp.moe_capacity(tm) == rmlp.moe_capacity(rm)
    assert tmlp.moe_capacity(registry.get("deepseek_v2_lite_16b").moe) == 32


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_router_probs_matches_jax(name, zero_router):
    rcfg, tcfg, rp, mod = _moe(name, zero_router=zero_router)
    x = _x(rcfg)
    rl, rpr, rtp, rti = rmlp.router_probs(rp, jnp.asarray(x), rcfg.moe)
    tl, tpr, ttp, tti = tmlp.router_probs(mod, torch.from_numpy(x), tcfg.moe)
    assert tti.dtype == torch.int64 and ttp.dtype == torch.float32
    np.testing.assert_array_equal(tti.numpy(), np.asarray(rti))
    np.testing.assert_allclose(ttp.numpy(), np.asarray(rtp), rtol=2e-6)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(rpr), rtol=2e-6,
                               atol=1e-7)
    if zero_router:       # ties everywhere: experts 0 .. k-1, equal gates
        assert (tti.numpy() == np.arange(tcfg.moe.top_k)).all()
        np.testing.assert_array_equal(ttp.numpy(), np.asarray(rtp))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_moe_fwd_matches_jax(name, dtype):
    tdt, jdt = DTYPES[dtype]
    rcfg, tcfg, rp, mod = _moe(name)
    x = _x(rcfg, (2, 96), scale=0.5)          # 192 tokens, 3 groups of 64
    want, raux = rmlp.moe_fwd(rp, jnp.asarray(x, jdt), rcfg)
    got, taux = tmlp.moe_fwd(mod, torch.from_numpy(x).to(tdt), tcfg)
    assert got.dtype == tdt and taux.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        m = tcfg.moe
        xg = x.reshape(3, m.group_size, -1)
        slot, keep, gate = _ref_route(rp, jnp.asarray(xg), rcfg.moe)
        *_, top_p, _, tslot, tkeep = tmlp.moe_route(mod, torch.from_numpy(xg),
                                                    m)
        np.testing.assert_array_equal(tslot.numpy(), slot)
        np.testing.assert_array_equal(tkeep.numpy(), keep)
        assert keep.min() == 0.0              # some claims are dropped
        np.testing.assert_allclose((top_p * tkeep).numpy(), gate, rtol=2e-6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5)
    else:
        assert _rel_l2(got, want) <= 1e-2
        np.testing.assert_allclose(float(taux), float(raux), rtol=1e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_moe_fwd_dense_eval_matches_jax(name, dtype):
    tdt, jdt = DTYPES[dtype]
    rcfg, tcfg, rp, mod = _moe(name)
    x = _x(rcfg, (2, 40), seed=3)
    want = np.asarray(rmlp.moe_fwd_dense_eval(
        rp, jnp.asarray(x, jdt), rcfg).astype(jnp.float32))
    got = tmlp.moe_fwd_dense_eval(mod, torch.from_numpy(x).to(tdt), tcfg)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        assert _rel_l2(got.float().numpy(), want) <= 1e-2


def test_zero_router_aux_is_balanced():
    """The reference's bound: a uniform router's Switch loss is ~ the aux
    weight, so aux < 3 x `router_aux_weight`; and equal to the
    reference's (rtol 1e-6)."""
    rcfg, tcfg, rp, mod = _moe("arctic_480b", key=13, zero_router=True)
    x = np.array(jax.random.normal(jax.random.key(14), (2, 64, 64)))
    _, raux = rmlp.moe_fwd(rp, jnp.asarray(x), rcfg)
    _, taux = tmlp.moe_fwd(mod, torch.from_numpy(x), tcfg)
    assert float(taux) < 3 * tcfg.moe.router_aux_weight
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-6)


def test_groupwise_close_to_dropfree():
    """As the reference's `test_moe_groupwise_close_to_dropfree`: capacity
    drops zero a few tokens' routed experts; most rows agree to 1e-3."""
    rcfg, tcfg, rp, mod = _moe("arctic_480b", key=11)
    x = torch.from_numpy(_x(rcfg, (2, 64), seed=12, scale=0.5))
    y, aux = tmlp.moe_fwd(mod, x, tcfg)
    yd = tmlp.moe_fwd_dense_eval(mod, x, tcfg)
    diff = (y - yd).reshape(-1, tcfg.d_model).norm(dim=-1)
    base = yd.reshape(-1, tcfg.d_model).norm(dim=-1) + 1e-6
    assert float(((diff / base) < 1e-3).float().mean()) > 0.85
    assert bool(torch.isfinite(aux))


def test_moe_fwd_refuses_ragged_groups():
    _, tcfg, _, mod = _moe("arctic_480b")
    with pytest.raises(ValueError, match="groups"):
        tmlp.moe_fwd(mod, torch.zeros((1, 100, tcfg.d_model)), tcfg)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_moe_a2a_matches_dropfree(n):
    """`moe_fwd_a2a` on n CPU positions at the reference test's capacity
    (512: nothing dropped) against `moe_fwd_dense_eval` (the reference
    test's atol = rtol = 2e-3; measured <= 5e-7), and the same bits on
    every position count."""
    rcfg, tcfg, rp, mod = _moe("arctic_480b")
    x = torch.from_numpy(0.5 * np.asarray(
        jax.random.normal(jax.random.key(1), (4, 16, tcfg.d_model))))
    want = tmlp.moe_fwd_dense_eval(mod, x, tcfg)
    got = moe_fwd_a2a(mod, x, tcfg, ("cpu",) * n, capacity=512)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    assert float((got - want).abs().max()) <= 5e-6
    assert torch.equal(got, moe_fwd_a2a(mod, x, tcfg, ("cpu",), capacity=512))
    with pytest.raises(ValueError, match="split"):
        moe_fwd_a2a(mod, x, tcfg, ("cpu",) * 3)


@pytest.mark.slow
def test_moe_a2a_matches_jax_mesh(tmp_path):
    """Against the reference's `moe_fwd_a2a` on a (1, n) forced-host mesh
    (a subprocess: the device count is fixed when JAX starts), n = 1, 2,
    4, in float32 at capacity 8 (claims dropped) and 512: the rows whose
    routed experts were dropped (y far from the drop-free oracle) are the
    same rows in both, and y agrees at rtol 1e-5, atol 1e-6."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import registry as creg
        from repro.models import mlp
        from repro.parallel.moe_a2a import moe_fwd_a2a
        cfg = creg.reduced("arctic_480b")
        p = mlp.init_moe(jax.random.key(0), cfg.d_model, cfg)
        x = 0.5 * jax.random.normal(jax.random.key(1), (4, 16, cfg.d_model))
        out = {{}}
        for n in (1, 2, 4):
            mesh = jax.make_mesh((1, n), ("data", "model"))
            for cap in (8, 512):
                out[f"y{{n}}_{{cap}}"] = np.asarray(
                    moe_fwd_a2a(p, x, cfg, mesh, capacity=cap))
        np.savez("{tmp_path}/ref.npz", **out)
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    rcfg, tcfg, rp, mod = _moe("arctic_480b")
    x = torch.from_numpy(0.5 * np.asarray(
        jax.random.normal(jax.random.key(1), (4, 16, tcfg.d_model))))
    free = tmlp.moe_fwd_dense_eval(mod, x, tcfg).numpy().reshape(64, -1)
    for n in (1, 2, 4):
        for cap in (8, 512):
            got = moe_fwd_a2a(mod, x, tcfg, ("cpu",) * n,
                              capacity=cap).numpy()
            want = ref[f"y{n}_{cap}"]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            far_t = np.abs(got.reshape(64, -1) - free).max(-1) > 1e-4
            far_r = np.abs(want.reshape(64, -1) - free).max(-1) > 1e-4
            np.testing.assert_array_equal(far_t, far_r)
            assert far_t.any() == (cap == 8)
