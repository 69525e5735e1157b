"""The port's SSM family (`configs/xlstm_125m.py`, `models/xlstm.py`, the
SSM branches of `models/lm.py`, `models/registry.py`, `convert.py`,
`launch/steps.py`, `launch/shapes.py`, `data/synthetic.py`,
`serve/engine.py`, `train/trainer.py`) held against the JAX reference on
the CPU.

Model: `xlstm-reduced` (one (mLSTM, sLSTM) pair, d 64, 2 heads, vocab
512; mLSTM width 128 (proj_factor 2), head dim 64, conv 4, chunk 16;
sLSTM head dim 32).  Parameters come from the reference's `init_lm`
with the norm scales and biases, `conv_b`, `b_if` and `b_gates` moved
off their initial values by numpy draws, carried over by
`convert.lm_params_from_numpy`; inputs are numpy draws.

The backbone is bf16 in both packages (the embedding's cast), so the
arithmetic is held tightly with a float32 backbone set on both sides
(the reference's `lm.jnp` read through a stand-in whose `bfloat16` is
float32, the port's `lm.BACKBONE`); the mixers alone are held on
float32 and bf16 inputs.  Tolerances (measured on a CPU):

- `mlstm_fwd`, `mlstm_fwd_chunked`, `slstm_fwd` on float32 inputs: rtol
  1e-5, atol 1e-5 (measured max abs <= 3.6e-7); on bf16 inputs rel L2
  <= 5e-2 (measured <= 8.0e-3; the sLSTM bit-equal); the port's chunked
  form against its own recurrence in float32 at 1, 2 and 4 chunks: rtol
  1e-5, atol 1e-5 (measured max abs 1.8e-8).
- `mlstm_decode` and `slstm_decode` step by step over 12 tokens from
  the initial state, outputs and states, float32: rtol 1e-5, atol 1e-5
  (measured max abs 9.5e-7).
- `lm_hidden` / `lm_logits`, recurrent and chunked, float32 backbone:
  rtol 1e-5, atol 1e-5 (measured max abs 1.4e-6); bf16: rel L2 <= 5e-2
  (measured <= 4.2e-3).
- `lm_loss` (chunked, the train step's form) and its grads: float32
  loss rtol 1e-5 (measured 6.8e-8), each grad leaf rel L2 <= 1e-4
  (measured <= 2.0e-6); bf16 loss rtol 2e-3 (measured 1.4e-6), each
  leaf rel L2 <= 5e-2 (measured <= 3.8e-2); every grad finite (the
  chunked form's masked `exp` is where a NaN could enter).
- One `make_train_step` step (remat, the mLSTM chunkwise) at 1 and 2
  microbatches against the reference's `value_and_grad(lm_loss)` +
  `adamw.update`: the bounds of `lm_loss` (measured loss and grad norm
  rel <= 8.4e-8 in float32, <= 5.0e-4 in bf16), grad norm rtol 1e-4 /
  2e-2, each first moment and updated parameter rel L2 <= 1e-4 / 5e-2
  (measured 2.2e-6 / 3.8e-2), every element within 2.2 lr (measured
  0.134 lr in float32, 2.0017 lr in bf16: a grad sign the rounding flips
  moves AdamW's first step 2 lr) and >= 97 % within 0.1 lr (measured
  >= 99.71 %), `tests/test_torch_zamba2.py`'s bounds.
- Teacher-forced `decode_step` (serving weights) against the
  reference's over 12 tokens: float32 backbone rtol 1e-4, atol 1e-4
  (measured max abs 1.2e-6), argmax equal; bf16 rel L2 <= 5e-2
  (measured <= 4.0e-3), argmax equal where the reference's top-two gap
  is at least 5e-2.
- `make_prefill_step` (serving weights): rel L2 <= 5e-2 (measured
  4.1e-3), argmax equal at >= 90 %.
- `ServeEngine`: completions equal to the reference's, its sampler fed
  the reference's Gumbel draws.
- `count_params`, serving dtypes, state-dict names, decode-state
  shapes, configs, `convert` round trip: exact.
"""
import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.launch import shapes as rshapes
from repro.launch import steps as rsteps
from repro.models import lm as rlm
from repro.models import registry as rmodels
from repro.models import xlstm as rxlstm
from repro.optim import adamw as radamw
from repro.serve import engine as rengine
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tmodels
from repro_torch.models import xlstm as txlstm
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import engine as tengine
from repro_torch.train.trainer import TrainerConfig, init_state
from torch_port_helpers import (F32Jnp, JaxGumbel, leaves, perturbed,
                                ref_train_step, rel_l2, serving_tree)

ROOT = Path(__file__).resolve().parents[1]
NAME = "xlstm_125m"
SEQ, BATCH, STEPS, MAX_SEQ = 32, 2, 12, 16
PERTURBED = ("['scale']", "['bias']", "['conv_b']", "['b_if']",
             "['b_gates']")
NEAR_TIE = 5e-2


@contextlib.contextmanager
def _f32_backbone(monkeypatch, on: bool = True):
    """Both packages' backbones in float32 (when `on`) for the block."""
    if not on:
        yield
        return
    with monkeypatch.context() as m:
        m.setattr(rlm, "jnp", F32Jnp())
        m.setattr(tlm, "BACKBONE", torch.float32)
        yield


@pytest.fixture(scope="module")
def models():
    """(reference cfg, port cfg, reference params, port LM)."""
    rcfg, tcfg = rregistry.reduced(NAME), registry.reduced(NAME)
    rp = perturbed(rlm.init_lm(jax.random.key(0), rcfg), PERTURBED, 5)
    model = tlm.LM(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    return rcfg, tcfg, rp, model


def _tokens(cfg, seed=2, seq=SEQ):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (BATCH, seq))


def _x(cfg, dtype, seed=3, seq=SEQ):
    """Mixer inputs (B, S, D) of both packages from one numpy draw."""
    x = np.random.default_rng(seed).standard_normal(
        (BATCH, seq, cfg.d_model)).astype(np.float32)
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _layer(rp, part):
    return jax.tree.map(lambda a: a[0], rp["blocks"][part])


def _close(got, want, f32: bool, bound: float = 5e-2):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    if f32:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        assert rel_l2(g, w) <= bound, rel_l2(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["mlstm_fwd", "mlstm_fwd_chunked",
                                "slstm_fwd"])
def test_mixers_match_jax(models, fn, dtype):
    """Each mixer of layer 0 on the same inputs: the mLSTM as the
    stabilized recurrence and chunkwise (2 chunks of 16), the sLSTM."""
    rcfg, tcfg, rp, model = models
    part = fn.split("_")[0]
    rx, tx = _x(rcfg, dtype)
    want = jax.jit(lambda p, x: getattr(rxlstm, fn)(p, x, rcfg))(
        _layer(rp, part), rx)
    with torch.no_grad():
        got = getattr(txlstm, fn)(getattr(model.blocks[0], part), tx, tcfg)
    assert got.dtype == tx.dtype
    _close(got, want, dtype == "float32")


def test_mlstm_chunked_equals_its_recurrence(models):
    """The port's chunkwise form against its own stabilized recurrence, at
    one chunk, two and four."""
    _, tcfg, _, model = models
    _, x = _x(tcfg, "float32", seed=4, seq=64)
    p = model.blocks[0].mlstm
    with torch.no_grad():
        want = txlstm.mlstm_fwd(p, x, tcfg).numpy()
        for chunk in (64, 32, 16):
            cfg = dataclasses.replace(tcfg, xlstm=dataclasses.replace(
                tcfg.xlstm, chunk=chunk))
            got = txlstm.mlstm_fwd_chunked(p, x, cfg).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError, match="chunk"):
            txlstm.mlstm_fwd_chunked(p, x[:, :40], tcfg)


def test_mixer_decodes_match_jax_step_by_step(models):
    """`mlstm_decode` and `slstm_decode` from their initial states over
    STEPS tokens, float32: outputs and every state leaf each step."""
    rcfg, tcfg, rp, model = models
    rx, tx = _x(rcfg, "float32", seed=6, seq=STEPS)
    blk = model.blocks[0]
    for part in ("mlstm", "slstm"):
        rdec = jax.jit(lambda p, x, st, f=getattr(rxlstm, f"{part}_decode"):
                       f(p, x, st, rcfg))
        tdec = getattr(txlstm, f"{part}_decode")
        rstate = getattr(rxlstm, f"init_{part}_state")(rcfg, BATCH)
        tstate = getattr(txlstm, f"init_{part}_state")(tcfg, BATCH,
                                                       device="cpu")
        assert set(tstate) == set(rstate)
        for k in rstate:
            np.testing.assert_array_equal(tstate[k].numpy(), rstate[k])
        lp = _layer(rp, part)
        for t in range(STEPS):
            want, rstate = rdec(lp, rx[:, t], rstate)
            with torch.no_grad():
                got, tstate = tdec(getattr(blk, part), tx[:, t], tstate, tcfg)
            _close(got, want, True)
            for k in rstate:
                _close(tstate[k], rstate[k], True)


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunked", [False, True])
def test_lm_hidden_and_logits_match_jax(models, chunked, backbone,
                                        monkeypatch):
    """The (mLSTM, sLSTM) pairs, then the untied head."""
    rcfg, tcfg, rp, model = models
    toks = _tokens(rcfg)
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32), torch.no_grad():
        want, want_l = jax.jit(lambda p, t: _ref_logits(p, t, rcfg,
                                                        chunked))(
            rp, jnp.asarray(toks))
        got, aux = tlm.lm_hidden(model, torch.from_numpy(toks), tcfg,
                                 mlstm_chunked=chunked)
        got_l = tlm.lm_logits(model, got, tcfg)
    assert float(aux) == 0.0
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    _close(got, want, f32)
    _close(got_l, want_l, f32)


def _ref_logits(p, toks, cfg, chunked: bool, **kw):
    """The reference's (hidden, logits)."""
    hidden, _ = rlm.lm_hidden(p, toks, cfg, mlstm_chunked=chunked, **kw)
    return hidden, rlm.lm_logits(p, hidden, cfg)


def _train_batch(cfg, seed=7):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (BATCH, SEQ + 1))
    return {"inputs": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
def test_lm_loss_and_grads_match_jax(models, backbone, monkeypatch):
    """`lm_loss` with the chunkwise mLSTM (the train step's): the loss,
    and every grad leaf finite and at the reference's."""
    rcfg, tcfg, rp, model = models
    batch = _train_batch(rcfg)
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32):
        (rl, rm), rg = jax.jit(jax.value_and_grad(
            lambda p, b: rlm.lm_loss(p, b, rcfg, mlstm_chunked=True),
            has_aux=True))(rp, jax.tree.map(jnp.asarray, batch))
        model.zero_grad(set_to_none=True)
        tl, tm = tlm.lm_loss(model, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, tcfg,
                             mlstm_chunked=True)
        tl.backward()
    assert set(tm) == set(rm) == {"nll", "z_loss", "ppl_proxy", "aux_loss"}
    np.testing.assert_allclose(float(tl.detach()), float(rl),
                               rtol=1e-5 if f32 else 2e-3)
    got = leaves(convert.lm_params_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    want = leaves(rg)
    assert set(got) == set(want)
    assert any("slstm" in k for k in want) and any("mlstm" in k for k in want)
    for k in want:
        assert np.isfinite(got[k]).all() and np.isfinite(want[k]).all(), k
        assert rel_l2(got[k], want[k]) <= (1e-4 if f32 else 5e-2), \
            (k, rel_l2(got[k], want[k]))


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_composition(models, microbatches, backbone,
                                            monkeypatch):
    """One `make_train_step` step (remat, the mLSTM chunkwise, as the
    reference's `make_train_step` builds its loss) against the
    reference's `value_and_grad(lm_loss)` and `adamw.update`."""
    rcfg, tcfg, rp, _ = models
    batch = _train_batch(rcfg)
    f32 = backbone == "float32"
    ocfg = radamw.AdamWConfig()
    with _f32_backbone(monkeypatch, f32):
        want_p, want_opt, want_m = ref_train_step(
            lambda p, b: rlm.lm_loss(p, b, rcfg, remat=True,
                                     mlstm_chunked=True), rp,
            radamw.init(rp, ocfg), batch, microbatches, ocfg, jit=True)
        state = init_state(tcfg, TrainerConfig(), device="cpu")
        state["params"].load_state_dict(convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, rp)), strict=True)
        step = tsteps.make_train_step(tcfg, microbatches=microbatches,
                                      device="cpu")
        state, met = step.fn(state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    assert int(state["step"]) == 1 and int(state["opt"]["count"]) == 1
    np.testing.assert_allclose(float(met["loss"]), float(want_m["loss"]),
                               rtol=1e-5 if f32 else 2e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(want_m["grad_norm"]),
                               rtol=1e-4 if f32 else 2e-2)
    lr = float(want_m["lr"])
    np.testing.assert_allclose(float(met["lr"]), lr, rtol=1e-6)
    bound = 1e-4 if f32 else 5e-2
    got_m = leaves(convert.opt_state_to_numpy(state["opt"])["m"])
    want_g = leaves(want_opt["m"])
    got_p = leaves(convert.lm_params_to_numpy(state["params"]))
    want_p = leaves(want_p)
    assert set(got_m) == set(want_g) == set(got_p) == set(want_p)
    for k in want_g:
        assert rel_l2(got_m[k], want_g[k]) <= bound, (k, rel_l2(
            got_m[k], want_g[k]))
        assert rel_l2(got_p[k], want_p[k]) <= bound, k
    diff = np.concatenate([np.abs(got_p[k] - want_p[k]).ravel()
                           for k in want_p])
    assert diff.max() <= 2.2 * lr, diff.max() / lr
    assert np.mean(diff <= 0.1 * lr) >= 0.97, np.mean(diff <= 0.1 * lr)


def test_init_decode_state_shapes_and_dtypes():
    """float32 recurrent states stacked over the pairs, the same as the
    reference's (m at -1e30), and of a size independent of max_seq."""
    cfg, rcfg = registry.reduced(NAME), rregistry.reduced(NAME)
    state = tlm.init_decode_state(cfg, 3, 10, device="cpu")
    rstate = rlm.init_decode_state(rcfg, 3, 10)
    got = leaves(jax.tree.map(lambda t: t.numpy(), state["caches"]))
    want = leaves(rstate["caches"])
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert state["pos"] == 0
    assert got["['mlstm']['c']"].shape == (1, 3, 2, 64, 64)
    assert got["['slstm']['m']"].shape == (1, 3, 2, 32)
    big = tlm.init_decode_state(registry.get(NAME), 1, 524288, device="meta")
    small = tlm.init_decode_state(registry.get(NAME), 1, 1, device="meta")
    shapes = jax.tree.map(lambda t: tuple(t.shape), big["caches"])
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), small["caches"])
    assert shapes["mlstm"]["c"] == (6, 1, 4, 384, 384)
    assert shapes["mlstm"]["conv"] == (6, 1, 3, 1536)
    assert shapes["slstm"]["h"] == (6, 1, 4, 192)


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
def test_decode_matches_jax(models, backbone, monkeypatch):
    """Teacher-forced `decode_step` (serving weights) against the
    reference's step by step; the states are written in place."""
    rcfg, tcfg, rp, model = models
    rserve = serving_tree(rp)
    serve = tlm.LM(tcfg, torch.Generator(), dtype=torch.bfloat16)
    serve.load_state_dict(model.state_dict())
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (BATCH, STEPS))
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32):
        rstep = jax.jit(lambda p, s, t: rlm.decode_step(p, s, t, rcfg))
        rstate = rlm.init_decode_state(rcfg, BATCH, MAX_SEQ)
        api = tmodels.build_model(tcfg)
        tstate = api.init_decode_state(BATCH, MAX_SEQ, device="cpu")
        c = tstate["caches"]["mlstm"]["c"]
        for t in range(STEPS):
            want, rstate = rstep(rserve, rstate,
                                 jnp.asarray(toks[:, t], jnp.int32))
            got, tstate = api.decode_step(serve, tstate,
                                          torch.from_numpy(toks[:, t]))
            want, got = np.asarray(want), got.numpy()
            if f32:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            else:
                assert rel_l2(got, want) <= 5e-2, (t, rel_l2(got, want))
            top2 = np.sort(want, -1)[:, -2:]
            clear = f32 | (top2[:, 1] - top2[:, 0] >= NEAR_TIE)
            assert (got.argmax(-1) == want.argmax(-1))[clear].all(), t
    assert tstate["pos"] == STEPS
    assert tstate["caches"]["mlstm"]["c"] is c           # written in place
    # no cache bounds the recurrent state: past max_seq it decodes on
    logits, _ = api.decode_step(serve, dict(tstate, pos=MAX_SEQ + 5),
                                torch.zeros(BATCH, dtype=torch.int64))
    assert bool(torch.isfinite(logits).all())


def test_engine_matches_reference(models):
    """`ServeEngine` serves the reduced xlstm through `build_model`: six
    requests through four slots, two at temperature 0.8 fed the
    reference's draws: the reference's completions."""
    rcfg, tcfg, rp, model = models
    rng = np.random.default_rng(11)
    reqs = []
    for uid in range(6):
        prompt = [int(x) for x in rng.integers(1, rcfg.vocab,
                                               int(rng.integers(3, 9)))]
        reqs.append((uid, prompt, int(rng.integers(4, 9)),
                     0.8 if uid in (2, 5) else 0.0))
    reng = rengine.ServeEngine(rcfg, rp, slots=4, max_seq=64, seed=0)
    teng = tengine.ServeEngine(tcfg, model, slots=4, max_seq=64, seed=0,
                               device="cpu", noise=JaxGumbel(0))
    for uid, prompt, n, temp in reqs:
        reng.submit(rengine.Request(uid, prompt, max_new=n, temperature=temp))
        teng.submit(tengine.Request(uid, prompt, max_new=n, temperature=temp))
    want = [(c.uid, c.tokens) for c in reng.run()]
    got = [(c.uid, c.tokens) for c in teng.run()]
    assert got == want and sorted(u for u, _ in got) == list(range(6))


def test_prefill_step_logits_match_jax(models):
    """`make_prefill_step` (serving weights, the mLSTM chunkwise): logits
    at every position as the reference's prefill computes them."""
    rcfg, tcfg, rp, model = models
    rserve = serving_tree(rp)
    serve = tlm.LM(tcfg, torch.Generator(), dtype=torch.bfloat16)
    serve.load_state_dict(model.state_dict())
    toks = _tokens(rcfg, seed=4)
    want = np.asarray(jax.jit(lambda p, t: _ref_logits(
        p, t, rcfg, True, attn_impl="blockwise")[1])(
            rserve, jnp.asarray(toks)).astype(jnp.float32))
    step = tsteps.make_prefill_step(tcfg, ShapeSpec("t", "prefill", SEQ,
                                                    BATCH), device="cpu")
    assert step.batch_shapes == {"inputs": (BATCH, SEQ)}
    got = step.fn(serve, {"inputs": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == want.shape == (BATCH, SEQ, tcfg.vocab)
    assert rel_l2(got, want) <= 5e-2, rel_l2(got, want)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    with pytest.raises(ValueError, match="chunk"):
        step.fn(serve, {"inputs": torch.zeros((1, 40), dtype=torch.int64)})
    sstep = tsteps.make_serve_step(tcfg, tshapes.SHAPES["long_500k"],
                                   device="cpu")
    logits, state = sstep.fn(serve, sstep.init_state(),
                             torch.zeros(1, dtype=torch.int64))
    assert tuple(logits.shape) == (1, tcfg.vocab) and state["pos"] == 1


def test_serving_dtypes_match_to_serving_dtype():
    """Leaf by leaf, the serving weights have the reference's
    `_to_serving_dtype` shapes and dtypes: every stacked vector (`b_if`,
    `b_gates`, `conv_b`, the norms) bf16, `final_norm` float32."""
    for get in ("reduced", "get"):
        rcfg = getattr(rregistry, get)(NAME)
        tcfg = getattr(registry, get)(NAME)
        shapes = rsteps._to_serving_dtype(jax.eval_shape(
            lambda k: rlm.init_lm(k, rcfg), jax.random.key(0)))
        want = {jax.tree_util.keystr(p): (tuple(w.shape), str(w.dtype))
                for p, w in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        specs = jax.tree_util.tree_flatten_with_path(
            convert.train_state_tree(
                {"params": tmodels.meta_model(tcfg, torch.bfloat16)},
                spec=True)["params"],
            is_leaf=lambda x: isinstance(x, tshapes.TensorSpec))[0]
        got = {jax.tree_util.keystr(p): (tuple(g.shape), str(g.dtype).replace(
            "torch.", "")) for p, g in specs}
        assert got == want
    dtypes = {n: p.dtype for n, p in tmodels.meta_model(
        registry.reduced(NAME), torch.bfloat16).named_parameters()}
    for n in ("mlstm.b_if", "mlstm.conv_b", "slstm.b_gates", "ln1.scale",
              "slstm.r_gates"):
        assert dtypes[f"blocks.0.{n}"] == torch.bfloat16, n
    assert dtypes["final_norm.scale"] == torch.float32


def test_decay_mask_covers_the_stacked_vectors(models):
    """AdamW decays the stacked vectors (stacked rank 2), as the
    reference's `ndim >= 2` rule on its stacked tree, and not
    `final_norm`."""
    _, _, _, model = models
    mask = tadamw._decay_mask(dict(model.named_parameters()))
    for n in ("mlstm.b_if", "mlstm.conv_b", "slstm.b_gates", "ln2.bias",
              "mlstm.wq", "slstm.r_gates"):
        assert mask[f"blocks.0.{n}"], n
    assert not mask["final_norm.scale"] and not mask["final_norm.bias"]


@pytest.mark.parametrize("get", ["get", "reduced"])
def test_count_params_matches_jax(get):
    rcfg = getattr(rregistry, get)(NAME)
    tcfg = getattr(registry, get)(NAME)
    assert tmodels.count_params(tcfg) == rmodels.count_params(rcfg)
    assert tmodels.count_params(tcfg, active_only=True) == \
        rmodels.count_params(rcfg, active_only=True)
    assert tmodels.embedding_params(tcfg) == rmodels.embedding_params(rcfg)
    if get == "get":
        assert tcfg.n_params() == 162_359_856


def test_convert_round_trip(models):
    """The `blocks.<i>.{mlstm,slstm,ln1,ln2}.*` names: the reference's
    tree carried into the port and back with the same bits."""
    rcfg, tcfg, rp, model = models
    names = set(model.state_dict())
    assert {"blocks.0.mlstm.up", "blocks.0.mlstm.conv_w",
            "blocks.0.mlstm.b_if",
            "blocks.0.slstm.r_gates", "blocks.0.slstm.b_gates",
            "blocks.0.ln1.bias", "blocks.0.ln2.scale", "final_norm.bias",
            "emb", "head"} <= names
    assert len(model.blocks) == tlm.n_stacked_layers(tcfg) == 1
    back = leaves(convert.lm_params_to_numpy(model))
    want = leaves(rp)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert back["['blocks']['slstm']['r_gates']"].shape == (1, 2, 32, 128)


def test_configs_registry_and_model_cover_the_family():
    for get in ("get", "reduced"):
        tcfg = getattr(registry, get)("xlstm-125m")
        rcfg = getattr(rregistry, get)(NAME)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
        assert convert.arch_config_from_dict(dataclasses.asdict(rcfg)) == tcfg
        tlm.check_dense(tcfg)
        assert tmodels.build_model(tcfg).cfg == tcfg
        assert tlm.n_stacked_layers(tcfg) == rlm.n_stacked_layers(rcfg)
        assert txlstm.dims(tcfg) == rxlstm._dims(rcfg)
    assert NAME in registry.PORTED
    assert registry.ALIASES == rregistry.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in
            registry.all_configs().items()} == {
        k: dataclasses.asdict(v) for k, v in rregistry.all_configs().items()}
    cfg = registry.get(NAME)
    for name in tshapes.SHAPES:
        tb = tshapes.batch_struct(cfg, tshapes.SHAPES[name])
        rb = rshapes.batch_struct(rregistry.get(NAME), rshapes.SHAPES[name])
        assert {k: v.shape for k, v in tb.items()} == \
            {k: tuple(v.shape) for k, v in rb.items()}
        assert tshapes.microbatches_for(cfg, tshapes.SHAPES[name]) == \
            rshapes.microbatches_for(rregistry.get(NAME), rshapes.SHAPES[name])
        assert tshapes.applicable(cfg, tshapes.SHAPES[name]) == \
            rshapes.applicable(rregistry.get(NAME), rshapes.SHAPES[name])
    assert tshapes.applicable(cfg, tshapes.SHAPES["long_500k"])[0]
    for bad, what in ((dict(xlstm=None), "xlstm"), (dict(n_layers=3), "pairs"),
                      (dict(n_heads=5), "multiple")):
        with pytest.raises(ValueError, match=what):
            tlm.check_dense(dataclasses.replace(cfg, **bad))


def test_synthetic_batches_are_tokens_only():
    """`batch_for` gives the family the dense family's token batches
    (same vocabulary, seed and step) and nothing else, as the
    reference's."""
    ssm = registry.reduced(NAME)
    dense = dataclasses.replace(ssm, family="dense", xlstm=None)
    a = synthetic.batch_for(ssm, 32, 4, 3)
    assert set(a) == {"inputs", "targets"}
    b = synthetic.batch_for(dense, 32, 4, 3)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_train_cli_and_trainer_state(tmp_path):
    """`init_state` builds the LM through the registry; the launcher
    trains the reduced config on the CPU and checkpoints it."""
    cfg = registry.reduced(NAME)
    state = init_state(cfg, TrainerConfig(), device="cpu")
    assert isinstance(state["params"], tlm.LM)
    assert set(state["opt"]["m"]) == set(dict(
        state["params"].named_parameters()))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "xlstm-125m", "--reduced", "--device", "cpu", "--steps", "3",
           "--seq", "32", "--batch", "2", "--ckpt-dir", str(tmp_path),
           "--ckpt-every", "2"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "step     0 loss" in out.stdout
    assert (tmp_path / "LATEST").read_text() == "step_00000003"
