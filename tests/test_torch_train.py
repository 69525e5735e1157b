"""The port's training stack (`models.lm.lm_loss`, `optim.adamw`,
`launch.steps.make_train_step`) held against the JAX reference on the
CPU, on the reduced qwen2.5 config (2 layers, d 64, 4 heads / 2 KV
heads, vocab 512, QKV biases) with the reference's weights carried over
by `convert.lm_params_from_numpy`; tokens, grads and moments are drawn
with numpy.

The reference's jitted `make_train_step` does not run on this JAX (its
sharding rules raise `ShardingTypeError`), so the oracle is the plain
composition it jits: `jax.value_and_grad(lm.lm_loss)` and
`adamw.update`, with its microbatch loop written here.

Tolerances:
- `lm_loss`: the backbone is bf16 in both and XLA and torch round bf16
  products apart here and there: loss and metrics rtol 2e-3 (measured
  1.3e-4), each grad leaf rel L2 <= 5e-2 (measured <= 1.9e-2).
- AdamW on the same grads: float32 parameters and moments rtol 1e-6
  (the schedule's `cos` and `b ** count` may differ by ulps), moments
  also atol 1e-9 (b1 m + (1 - b1) g cancels where the signs differ:
  ulps of the ~1e-3 terms, measured 2.9e-11, 1.3e-6 relative); bf16
  moments within one bf16 ulp; int8 moments within one quantization
  step, scales rtol 1e-6.
- One train step: loss rtol 2e-3 (measured 5.4e-5), grad norm rtol
  2e-2 (measured 4.6e-4); updated parameters: AdamW's first step moves
  each element by about lr times the sign of its grad, so a grad whose
  sign the two backbones' rounding flips moves it 2 lr apart:
  |p_port - p_ref| <= 2.2 lr everywhere (measured 2.0017 lr) and <= 0.1
  lr on >= 97 % of the elements (measured 99.7 %).  The
  port's remat and its microbatches are held to themselves exactly
  where the arithmetic is the same (remat on equals off bit for bit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import TrainerConfig, init_state
from torch_port_helpers import ref_train_step  # (one torch thread per worker)

NAME = "qwen2_5_3b"
SEQ, BATCH = 32, 4


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _leaves(tree):
    """{keystr: numpy leaf} of a nested dict."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    rcfg, tcfg = rregistry.reduced(NAME), registry.reduced(NAME)
    rp = rlm.init_lm(jax.random.key(0), rcfg)
    rng = np.random.default_rng(5)
    # non-trivial norms and biases: the cast and decay rules read them
    rp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.1 * rng.standard_normal(
            a.shape).astype(np.float32))
        if jax.tree_util.keystr(path).endswith(("['scale']", "['bq']",
                                                "['bk']", "['bv']"))
        else a, rp)
    toks = rng.integers(0, rcfg.vocab, (BATCH, SEQ + 1))
    batch = {"inputs": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    return rcfg, tcfg, rp, batch


def _port_lm(tcfg, rp) -> tlm.LM:
    model = tlm.LM(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    return model


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_lm_loss_and_grads_match_jax(setup):
    rcfg, tcfg, rp, batch = setup
    (rl, rm), rg = jax.value_and_grad(
        lambda p, b: rlm.lm_loss(p, b, rcfg), has_aux=True)(
            rp, jax.tree.map(jnp.asarray, batch))
    model = _port_lm(tcfg, rp)
    tl, tm = tlm.lm_loss(model, _tbatch(batch), tcfg)
    tl.backward()
    assert set(tm) == set(rm) == {"nll", "z_loss", "ppl_proxy", "aux_loss"}
    np.testing.assert_allclose(float(tl.detach()), float(rl), rtol=2e-3)
    for k in rm:
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=2e-3,
                                   atol=1e-7)
    got = _leaves(convert.lm_params_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}))
    want = _leaves(rg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel_l2(got[k], want[k]) <= 5e-2, (k, _rel_l2(got[k], want[k]))


def test_remat_changes_nothing(setup):
    """`remat` recomputes each block in backward: the same loss and grads
    bit for bit."""
    _, tcfg, rp, batch = setup
    grads = []
    for remat in (False, True):
        model = _port_lm(tcfg, rp)
        loss, _ = tlm.lm_loss(model, _tbatch(batch), tcfg, remat=remat)
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p
                                      in model.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for n in grads[0][1]:
        assert torch.equal(grads[0][1][n], grads[1][1][n]), n


def test_decay_mask_follows_stacked_rank(setup):
    """Every leaf of a layer decays (the reference's stacked leaves are
    >= 2-D: norms and biases too); `final_norm.scale` does not."""
    _, tcfg, rp, _ = setup
    want = _leaves(radamw._decay_mask(rp))
    got = tadamw._decay_mask(dict(_port_lm(tcfg, rp).named_parameters()))
    stacked = _leaves(convert.lm_params_to_numpy(
        {n: torch.tensor(v) for n, v in got.items()}))
    assert set(stacked) == set(want)
    for k, v in want.items():
        assert np.all(stacked[k] == bool(v)), k
    assert not got["final_norm.scale"] and got["blocks.0.ln1.scale"] \
        and got["blocks.1.attn.bq"]


@pytest.mark.parametrize("count", [1, 100, 10_000])
def test_schedule_matches_jax(count):
    cfg = tadamw.AdamWConfig()
    want = radamw.schedule(radamw.AdamWConfig(), jnp.int32(count))
    got = tadamw.schedule(cfg, torch.tensor(count, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _opt_pair(rp, tmodel, count, kind, rng):
    """A reference AdamW state with random moments at `count` and the
    port's copy of it (bf16 / int8 moments made by each side's own
    casts from the same float32 draws)."""
    rcfg = {"f32": radamw.AdamWConfig(),
            "bf16": radamw.AdamWConfig(moment_dtype=jnp.bfloat16),
            "int8": radamw.AdamWConfig(quantized_moments=True)}[kind]
    tcfg = {"f32": tadamw.AdamWConfig(),
            "bf16": tadamw.AdamWConfig(moment_dtype=torch.bfloat16),
            "int8": tadamw.AdamWConfig(quantized_moments=True)}[kind]
    m = jax.tree.map(lambda a: jnp.asarray(
        1e-2 * rng.standard_normal(a.shape).astype(np.float32)), rp)
    v = jax.tree.map(lambda a: jnp.asarray(
        1e-4 * rng.random(a.shape).astype(np.float32)), rp)
    if kind == "int8":
        q = lambda a: dict(zip(("q", "s"), radamw.quantize_blockwise(  # noqa
            a, rcfg.quant_block)))
        m, v = jax.tree.map(q, m), jax.tree.map(q, v)
    else:
        m = jax.tree.map(lambda a: a.astype(rcfg.moment_dtype), m)
        v = jax.tree.map(lambda a: a.astype(rcfg.moment_dtype), v)
    ropt = {"m": m, "v": v, "count": jnp.int32(count - 1)}
    topt = convert.opt_state_from_numpy({
        "m": jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                          if a.dtype == jnp.bfloat16 else np.asarray(a), m),
        "v": jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                          if a.dtype == jnp.bfloat16 else np.asarray(a), v),
        "count": np.int32(count - 1)})
    if kind == "bf16":
        for k in ("m", "v"):
            topt[k] = {n: t.to(torch.bfloat16) for n, t in topt[k].items()}
    return rcfg, tcfg, ropt, topt


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("count", [1, 100, 10_000])
def test_adamw_update_matches_jax(setup, kind, count):
    """The same numpy grads fed to both updates; grads scaled so the
    global norm (~26) is clipped to 1."""
    _, tcfg, rp, _ = setup
    rng = np.random.default_rng(count)
    model = _port_lm(tcfg, rp)
    rcfg, ocfg, ropt, topt = _opt_pair(rp, model, count, kind, rng)
    g = jax.tree.map(lambda a: jnp.asarray(
        0.1 * rng.standard_normal(a.shape).astype(np.float32)), rp)
    rnew, ropt2, rmet = radamw.update(g, ropt, rp, rcfg)
    named = dict(model.named_parameters())
    tg = convert.lm_params_from_numpy(jax.tree.map(np.asarray, g))
    _, topt2, tmet = tadamw.update(tg, topt, named, ocfg)
    assert float(rmet["clip_scale"]) < 0.1
    for k in ("grad_norm", "lr", "clip_scale"):
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]), rtol=1e-6)
    assert int(topt2["count"]) == int(ropt2["count"]) == count
    got_p, want_p = _leaves(convert.lm_params_to_numpy(model)), _leaves(rnew)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    for mom in ("m", "v"):
        got = _leaves(convert.opt_state_to_numpy(topt2)[mom])
        want = _leaves(jax.tree.map(
            lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16
            else a, ropt2[mom]))
        assert set(got) == set(want)
        for k in want:
            if kind == "f32":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-9, err_msg=k)
            elif kind == "bf16":
                np.testing.assert_allclose(got[k], want[k], rtol=2 ** -7,
                                           atol=1e-30, err_msg=k)
            elif k.endswith("['s']"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           err_msg=k)
            else:
                assert np.abs(got[k].astype(np.int32)
                              - want[k].astype(np.int32)).max() <= 1, k


def _ref_train_step(rcfg, rp, ropt, batch, microbatches, opt_cfg):
    """The reference's train step unjitted over `lm_loss`
    (`torch_port_helpers.ref_train_step`)."""
    new_p, _, met = ref_train_step(lambda p, b: rlm.lm_loss(p, b, rcfg), rp,
                                   ropt, batch, microbatches, opt_cfg)
    return new_p, met


def _port_state(tcfg, rp):
    state = init_state(tcfg, TrainerConfig(), device="cpu")
    state["params"].load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    return state


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_composition(setup, microbatches):
    rcfg, tcfg, rp, batch = setup
    ocfg = radamw.AdamWConfig()
    want_p, want_m = _ref_train_step(rcfg, rp, radamw.init(rp, ocfg), batch,
                                     microbatches, ocfg)
    step = tsteps.make_train_step(tcfg, microbatches=microbatches,
                                  device="cpu")
    state, met = step.fn(_port_state(tcfg, rp), _tbatch(batch))
    assert int(state["step"]) == 1 and int(state["opt"]["count"]) == 1
    assert set(met) == set(want_m) | {"nll", "z_loss", "ppl_proxy",
                                      "aux_loss"}
    np.testing.assert_allclose(float(met["loss"]), float(want_m["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=2e-2)
    np.testing.assert_allclose(float(met["lr"]), float(want_m["lr"]),
                               rtol=1e-6)
    lr = float(want_m["lr"])
    got, want = _leaves(convert.lm_params_to_numpy(state["params"])), \
        _leaves(want_p)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diff.max() <= 2.2 * lr, diff.max() / lr
    assert np.mean(diff <= 0.1 * lr) >= 0.97, np.mean(diff <= 0.1 * lr)


def test_train_step_remat_and_microbatches(setup):
    """In the port, remat on equals remat off bit for bit; two
    microbatches differ from one by the float32 rounding of the sums."""
    _, tcfg, rp, batch = setup
    out = {}
    for remat, mb in ((True, 1), (False, 1), (True, 2)):
        step = tsteps.make_train_step(tcfg, remat=remat, microbatches=mb,
                                      device="cpu")
        state, met = step.fn(_port_state(tcfg, rp), _tbatch(batch))
        out[remat, mb] = (met, dict(state["params"].named_parameters()),
                          state["opt"])
    (m1, p1, o1), (m0, p0, o0) = out[True, 1], out[False, 1]
    for k in m1:
        assert torch.equal(m1[k], m0[k]), k
    for n in p1:
        assert torch.equal(p1[n], p0[n]), n
        assert torch.equal(o1["m"][n], o0["m"][n]), n
    m2 = out[True, 2][0]
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=2e-2)


def test_cast_bf16_matches_jax(setup):
    """`cast_bf16=True` runs the loss on a bf16 cast of every leaf of
    stacked rank >= 2 (norm scales and biases of the layers too), as the
    reference's `loss_fn` does."""
    rcfg, tcfg, rp, batch = setup
    cast = jax.tree.map(lambda p: p.astype(jnp.bfloat16)
                        if p.ndim >= 2 and p.dtype == jnp.float32 else p, rp)
    want = float(rlm.lm_loss(cast, jax.tree.map(jnp.asarray, batch),
                             rcfg)[0])
    step = tsteps.make_train_step(tcfg, cast_bf16=True, device="cpu")
    _, met = step.fn(_port_state(tcfg, rp), _tbatch(batch))
    np.testing.assert_allclose(float(met["loss"]), want, rtol=2e-3)
    view = tsteps._cast_view(_port_lm(tcfg, rp), torch.bfloat16)
    assert view.blocks[0].ln1.scale.dtype == torch.bfloat16
    assert view.blocks[1].attn.bq.dtype == torch.bfloat16
    assert view.final_norm.scale.dtype == torch.float32


def test_step_constants_match_reference():
    from repro.launch import steps as rsteps

    for name in ("qwen2_5_3b", "qwen3_8b"):
        rc, tc = rregistry.get(name), registry.get(name)
        r, t = rsteps.default_opt_cfg(rc), tsteps.default_opt_cfg(tc)
        # the port's leaves are a layer each: no scan_update_threshold
        rd = {k: v for k, v in dataclasses.asdict(r).items()
              if k not in ("moment_dtype", "scan_update_threshold")}
        td = {k: v for k, v in dataclasses.asdict(t).items()
              if k != "moment_dtype"}
        assert rd == td and t.moment_dtype == torch.float32
        assert tsteps.accum_dtype(tc) == torch.float32
        assert rsteps.accum_dtype(rc) == jnp.float32
    assert set(tsteps.PARAM_DTYPE) == set(rsteps.PARAM_DTYPE)
