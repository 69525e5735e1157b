"""The port's audio family (`configs/whisper_large_v3.py`,
`models/whisper.py`, `models/common.sinusoidal_positions`,
`models/registry.py`, `convert.py`, `launch/steps.py`,
`launch/shapes.py`, `data/synthetic.py`, `serve/engine.py`,
`train/trainer.py`) held against the JAX reference on the CPU.

Model: `whisper-reduced` (2 encoder and 2 decoder layers, d 64, 4 heads
over 4 at head dim 16, d_ff 128, vocab 512, 32 stub frames; LayerNorm,
GELU, attention biases, learned decoder positions, the head tied to the
embedding).  Parameters come from the reference's `init_whisper` with
every norm scale and bias and every attention bias moved off its
initial value by numpy draws, carried over by
`convert.lm_params_from_numpy` (`enc_blocks` / `dec_blocks` stacked);
frames and tokens are numpy draws.

The backbone is bf16 in both packages (`astype(jnp.bfloat16)` in the
reference's whisper module), so the arithmetic is held tightly with a
float32 backbone set on both sides (the reference's `whisper.jnp` read
through a stand-in whose `bfloat16` is float32, the port's
`whisper.BACKBONE`).  Tolerances (measured on a CPU):

- `sinusoidal_positions`, `DTypePolicy`, the norm inits: equal.
- `encode`, `cross_kv` + `cross_attention_fwd`, `decode_fwd` dense and
  blockwise (head dim 16: the float32 plain version of the 3xTF32
  kernel), float32: rtol 1e-5, atol 1e-5 (measured max abs <= 1.1e-6);
  bf16: rel L2 <= 5e-2 (measured <= 6.6e-3; the cross-attention alone
  bit-equal).
- `whisper_loss` and its grads: float32 loss rtol 1e-5 (measured
  7.6e-8), each grad leaf rel L2 <= 1e-4 (measured <= 1.4e-6); bf16 loss
  rtol 2e-3 (measured 1.0e-5), each leaf rel L2 <= 5e-2 (measured <=
  1.4e-2).  Without RoPE the self-attention's key bias adds one constant
  to each query's scores, which the softmax ignores: its grad is 0 but
  for rounding, held to |g| <= 1e-7 in float32 (measured 2.7e-10) and
  1e-3 in bf16 (1.1e-5) on both sides, as
  `tests/test_torch_dense_configs.py` holds granite's.
- One `make_train_step` step (remat) at 1 and 2 microbatches against
  the reference's `value_and_grad(whisper_loss)` + `adamw.update`: the
  bounds of the loss (measured loss and grad norm rel <= 9.8e-8 in
  float32, <= 4.0e-5 in bf16), grad norm rtol 1e-4 / 2e-2, each first
  moment and updated parameter rel L2 <= 1e-4 / 5e-2 (measured 1.4e-6 /
  1.4e-2; the key biases' first moments as their grads), every element
  within 2.2 lr (measured 0.035 lr in float32, 2.0 lr in bf16: a grad
  sign the rounding flips moves AdamW's first step 2 lr) and >= 97 %
  within 0.1 lr (measured >= 99.96 %).
- `precompute_cross` then `whisper_decode_step` (serving weights)
  against the reference's over 12 tokens: float32 backbone rtol 1e-4,
  atol 1e-4 (measured max abs 1.7e-6), argmax equal; bf16 rel L2 <=
  5e-2 (measured <= 7.3e-3), argmax equal where the reference's top-two
  gap is at least 5e-2.
- `make_prefill_step` with frames (serving weights): rel L2 <= 5e-2
  (measured 7.0e-3), argmax equal at >= 90 %.
- `ServeEngine` (zero cross K / V, as the reference's engine serves),
  float32 backbone (see the test): completions equal to the reference's,
  its sampler fed the reference's Gumbel draws.
- `count_params`, serving dtypes, state-dict names, configs, `convert`
  round trip: exact.
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
from repro.models import common as rcommon
from repro.models import registry as rmodels
from repro.models import whisper as rwhisper
from repro.optim import adamw as radamw
from repro.serve import engine as rengine
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tmodels
from repro_torch.models import whisper as twhisper
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import engine as tengine
from repro_torch.train.trainer import TrainerConfig, init_state
from torch_port_helpers import (F32Jnp, JaxGumbel, leaves, perturbed,
                                ref_train_step, rel_l2, serving_tree)

ROOT = Path(__file__).resolve().parents[1]
NAME = "whisper_large_v3"
SEQ, BATCH, STEPS, MAX_SEQ = 32, 2, 12, 16
PERTURBED = ("['scale']", "['bias']", "['bq']", "['bk']", "['bv']")
NEAR_TIE = 5e-2


@contextlib.contextmanager
def _f32_backbone(monkeypatch, on: bool = True):
    """Both packages' backbones in float32 (when `on`) for the block."""
    if not on:
        yield
        return
    with monkeypatch.context() as m:
        m.setattr(rwhisper, "jnp", F32Jnp())
        m.setattr(twhisper, "BACKBONE", torch.float32)
        yield


@pytest.fixture(scope="module")
def models():
    """(reference cfg, port cfg, reference params, port Whisper)."""
    rcfg, tcfg = rregistry.reduced(NAME), registry.reduced(NAME)
    rp = perturbed(rwhisper.init_whisper(jax.random.key(0), rcfg),
                   PERTURBED, 5)
    model = twhisper.Whisper(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    return rcfg, tcfg, rp, model


def _frames(cfg, seed=3, batch=BATCH):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.encdec.enc_frames, cfg.d_model))).astype(np.float32)


def _tokens(cfg, seed=2, seq=SEQ):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (BATCH, seq))


def _close(got, want, f32: bool, bound: float = 5e-2):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    if f32:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        assert rel_l2(g, w) <= bound, rel_l2(g, w)


def test_sinusoidal_positions_equal_reference():
    for seq, d in ((32, 64), (1500, 1280), (7, 10)):
        got = tcommon.sinusoidal_positions(seq, d)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(rcommon.sinusoidal_positions(seq, d)))


def test_dtype_policy_and_norm_inits_match_reference():
    """`DTypePolicy` / `DEFAULT_POLICY` name the reference's dtypes and
    cast in to the compute dtype; `init_rmsnorm` / `init_layernorm` hold
    the reference's parameters."""
    pol, rpol = tcommon.DEFAULT_POLICY, rcommon.DEFAULT_POLICY
    for f in ("params", "compute", "accum"):
        assert str(getattr(pol, f)).replace("torch.", "") == \
            jnp.dtype(getattr(rpol, f)).name, f
    assert pol.cast_in(torch.ones(2)).dtype == torch.bfloat16
    assert tcommon.DTypePolicy(compute=torch.float32).cast_in(
        torch.ones(2, dtype=torch.float64)).dtype == torch.float32
    for d in (8, 64):
        for t, r in ((tcommon.init_rmsnorm(d), rcommon.init_rmsnorm(d)),
                     (tcommon.init_layernorm(d), rcommon.init_layernorm(d))):
            got = {n: p.detach().numpy() for n, p in t.named_parameters()}
            assert set(got) == set(r)
            for n in r:
                np.testing.assert_array_equal(got[n], np.asarray(r[n]))


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
def test_encode_matches_jax(models, backbone, monkeypatch):
    """Frames plus sinusoidal positions, two non-causal layers, the
    encoder's norm."""
    rcfg, tcfg, rp, model = models
    frames = _frames(rcfg)
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32), torch.no_grad():
        want = jax.jit(lambda p, f: rwhisper.encode(p, f, rcfg))(
            rp, jnp.asarray(frames))
        got = twhisper.encode(model, torch.from_numpy(frames), tcfg)
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    _close(got, want, f32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_jax(models, dtype):
    """`cross_kv` over encoder outputs and `cross_attention_fwd` of
    decoder states, layer 0's weights: every query sees every frame."""
    rcfg, tcfg, rp, model = models
    rng = np.random.default_rng(8)
    enc = rng.standard_normal((BATCH, rcfg.encdec.enc_frames,
                               rcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((BATCH, SEQ, rcfg.d_model)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    lp = jax.tree.map(lambda a: a[0], rp["dec_blocks"]["xattn"])

    def ref(p, e, x):
        k, v = rwhisper.cross_kv(p, e, rcfg)
        return k, v, rwhisper.cross_attention_fwd(p, x, k, v, rcfg)

    rk, rv, want = jax.jit(ref)(lp, jnp.asarray(enc, jdt),
                                jnp.asarray(x, jdt))
    p = model.dec_blocks[0].xattn
    with torch.no_grad():
        k, v = twhisper.cross_kv(p, torch.from_numpy(enc).to(tdt), tcfg)
        got = twhisper.cross_attention_fwd(p, torch.from_numpy(x).to(tdt),
                                           k, v, tcfg)
    assert tuple(k.shape) == (BATCH, rcfg.encdec.enc_frames, 4, 16)
    assert got.dtype == tdt
    for g, w in ((k, rk), (v, rv), (got, want)):
        _close(g, w, dtype == "float32")


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["dense", "blockwise"])
def test_decode_fwd_matches_jax(models, attn_impl, backbone, monkeypatch):
    """The teacher-forced decoder over the encoder's output: logits
    (tied head) at every position."""
    rcfg, tcfg, rp, model = models
    frames, toks = _frames(rcfg), _tokens(rcfg)
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32), torch.no_grad():
        want = jax.jit(lambda p, f, t: rwhisper.decode_fwd(
            p, t, rwhisper.encode(p, f, rcfg), rcfg, attn_impl=attn_impl))(
                rp, jnp.asarray(frames), jnp.asarray(toks))
        enc = twhisper.encode(model, torch.from_numpy(frames), tcfg)
        got = twhisper.decode_fwd(model, torch.from_numpy(toks), enc, tcfg,
                                  attn_impl=attn_impl)
    assert tuple(got.shape) == (BATCH, SEQ, tcfg.vocab)
    _close(got, want, f32)


def test_decode_fwd_runs_the_flash_kernel_once_a_layer(models, monkeypatch):
    """Blockwise: one `flash_attention` call per decoder layer on its
    (B, S, 4, 16) q (the 3xTF32 route's plain version on the CPU); the
    encoder and the cross-attention stay dense."""
    from repro_torch.kernels.flash_attention import kernel as fk

    _, tcfg, _, model = models
    seen = []
    real = fk.flash_attention_tf32x3

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(fk, "flash_attention_tf32x3", spy)
    with torch.no_grad():
        enc = twhisper.encode(model, torch.from_numpy(_frames(tcfg)), tcfg)
        assert seen == []
        twhisper.decode_fwd(model, torch.from_numpy(_tokens(tcfg)), enc,
                            tcfg, attn_impl="blockwise")
    assert seen == [((BATCH, SEQ, 4, 16), True)] * tcfg.n_layers
    with pytest.raises(ValueError, match="attn_impl"):
        twhisper.decode_fwd(model, torch.zeros((1, 4), dtype=torch.long),
                            enc[:1], tcfg, attn_impl="paged")


def _assert_rounding_only(got, want, f32: bool) -> None:
    """The self-attention's key bias without RoPE adds one constant to
    each query's scores, which the softmax ignores: its grad (and first
    moment) is 0 but for rounding on both sides, held to an absolute
    bound as `tests/test_torch_dense_configs.py` holds granite's."""
    zero = 1e-7 if f32 else 1e-3
    assert np.abs(got).max() <= zero >= np.abs(want).max(), \
        (np.abs(got).max(), np.abs(want).max())


def _train_batch(cfg, seed=7):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (BATCH, SEQ + 1))
    return {"frames": _frames(cfg, seed + 1),
            "inputs": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
def test_whisper_loss_and_grads_match_jax(models, backbone, monkeypatch):
    rcfg, tcfg, rp, model = models
    batch = _train_batch(rcfg)
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32):
        (rl, rm), rg = jax.jit(jax.value_and_grad(
            lambda p, b: rwhisper.whisper_loss(p, b, rcfg), has_aux=True))(
                rp, jax.tree.map(jnp.asarray, batch))
        model.zero_grad(set_to_none=True)
        tl, tm = twhisper.whisper_loss(model, {k: torch.from_numpy(v)
                                               for k, v in batch.items()},
                                       tcfg)
        tl.backward()
    assert set(tm) == set(rm) == {"nll", "z_loss", "ppl_proxy", "aux_loss"}
    assert float(tm["aux_loss"]) == 0.0
    np.testing.assert_allclose(float(tl.detach()), float(rl),
                               rtol=1e-5 if f32 else 2e-3)
    got = leaves(convert.lm_params_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    want = leaves(rg)
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(got[k]).all(), k
        if k.endswith("['bk']"):
            _assert_rounding_only(got[k], want[k], f32)
            continue
        assert rel_l2(got[k], want[k]) <= (1e-4 if f32 else 5e-2), \
            (k, rel_l2(got[k], want[k]))


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_composition(models, microbatches, backbone,
                                            monkeypatch):
    """One `make_train_step` step (remat, frames in the batch) against the
    reference's `value_and_grad(whisper_loss)` and `adamw.update`."""
    rcfg, tcfg, rp, _ = models
    batch = _train_batch(rcfg)
    f32 = backbone == "float32"
    ocfg = radamw.AdamWConfig()
    with _f32_backbone(monkeypatch, f32):
        want_p, want_opt, want_m = ref_train_step(
            lambda p, b: rwhisper.whisper_loss(p, b, rcfg, remat=True), rp,
            radamw.init(rp, ocfg), batch, microbatches, ocfg, jit=True)
        state = init_state(tcfg, TrainerConfig(), device="cpu")
        state["params"].load_state_dict(convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, rp)), strict=True)
        step = tsteps.make_train_step(tcfg, microbatches=microbatches,
                                      device="cpu")
        assert set(step.batch_struct) == {"inputs", "targets", "frames"}
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
        if k.endswith("['bk']"):
            _assert_rounding_only(got_m[k], want_g[k], f32)
        else:
            assert rel_l2(got_m[k], want_g[k]) <= bound, (k, rel_l2(
                got_m[k], want_g[k]))
        assert rel_l2(got_p[k], want_p[k]) <= bound, k
    diff = np.concatenate([np.abs(got_p[k] - want_p[k]).ravel()
                           for k in want_p])
    assert diff.max() <= 2.2 * lr, diff.max() / lr
    assert np.mean(diff <= 0.1 * lr) >= 0.97, np.mean(diff <= 0.1 * lr)


def _serving(rp, model, tcfg):
    serve = twhisper.Whisper(tcfg, torch.Generator(), dtype=torch.bfloat16)
    serve.load_state_dict(model.state_dict())
    return serving_tree(rp), serve


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
def test_decode_step_matches_jax(models, backbone, monkeypatch):
    """`precompute_cross` over the frames, then teacher-forced
    `whisper_decode_step` (serving weights) against the reference's step
    by step; the self-attention caches are written in place."""
    rcfg, tcfg, rp, model = models
    rserve, serve = _serving(rp, model, tcfg)
    frames = _frames(rcfg, seed=9)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (BATCH, STEPS))
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32):
        rck, rcv = jax.jit(lambda p, f: rwhisper.precompute_cross(
            p, f, rcfg))(rserve, jnp.asarray(frames))
        rstep = jax.jit(lambda p, s, t: rwhisper.whisper_decode_step(
            p, s, t, rcfg))
        rstate = dict(rwhisper.init_whisper_decode_state(rcfg, BATCH,
                                                         MAX_SEQ),
                      cross_k=rck, cross_v=rcv)
        tstate = twhisper.init_whisper_decode_state(tcfg, BATCH, MAX_SEQ,
                                                    device="cpu")
        ck, cv = twhisper.precompute_cross(serve, torch.from_numpy(frames),
                                           tcfg)
        assert ck.dtype == tstate["cross_k"].dtype
        assert tuple(ck.shape) == tuple(tstate["cross_k"].shape) == \
            rck.shape
        _close(ck, rck, f32)
        tstate.update(cross_k=ck, cross_v=cv)
        cache = tstate["caches"]["k"]
        for t in range(STEPS):
            want, rstate = rstep(rserve, rstate,
                                 jnp.asarray(toks[:, t], jnp.int32))
            got, tstate = twhisper.whisper_decode_step(
                serve, tstate, torch.from_numpy(toks[:, t]), tcfg)
            want, got = np.asarray(want), got.numpy()
            if f32:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            else:
                assert rel_l2(got, want) <= 5e-2, (t, rel_l2(got, want))
            top2 = np.sort(want, -1)[:, -2:]
            clear = f32 | (top2[:, 1] - top2[:, 0] >= NEAR_TIE)
            assert (got.argmax(-1) == want.argmax(-1))[clear].all(), t
    assert tstate["pos"] == STEPS and tstate["caches"]["k"] is cache
    with pytest.raises(ValueError, match="outside the cache"):
        twhisper.whisper_decode_step(serve, dict(tstate, pos=MAX_SEQ),
                                     torch.zeros(BATCH, dtype=torch.int64),
                                     tcfg)


def test_decode_state_matches_reference():
    """The decode state's leaves: the self-attention caches (L, B, H, S,
    Dh) bf16, the cross K / V (L, B, F, H, Dh) zero in the backbone's
    bf16; on the full config its cross K / V are 1500 frames deep."""
    rcfg, tcfg = rregistry.reduced(NAME), registry.reduced(NAME)
    st = twhisper.init_whisper_decode_state(tcfg, 3, 10, device="cpu")
    rst = rwhisper.init_whisper_decode_state(rcfg, 3, 10)
    got = leaves(jax.tree.map(lambda t: t.float().numpy(),
                              {k: v for k, v in st.items() if k != "pos"}))
    want = leaves({k: v for k, v in rst.items() if k != "pos"})
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for k, w in want.items():
        assert not w.any() and not got[k].any(), k
    assert st["cross_k"].dtype == st["caches"]["k"].dtype == torch.bfloat16
    assert st["pos"] == 0
    big = twhisper.init_whisper_decode_state(registry.get(NAME), 1, 8,
                                             device="meta")
    assert tuple(big["cross_k"].shape) == (32, 1, 1500, 20, 64)
    assert tuple(big["caches"]["v"].shape) == (32, 1, 20, 8, 64)


def test_engine_matches_reference(models, monkeypatch):
    """`ServeEngine` serves the reduced whisper through `build_model`
    with zero cross K / V, as the reference's engine does: six requests
    through four slots, two at temperature 0.8 fed the reference's
    draws: the reference's completions.  The backbone is float32 on both
    sides: the reduced config's tied head gives logits so close together
    that greedy bf16 decoding meets top-two gaps down to 5.7e-5, where
    the two packages' bf16 roundings pick apart."""
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
    with _f32_backbone(monkeypatch):
        want = [(c.uid, c.tokens) for c in reng.run()]
        got = [(c.uid, c.tokens) for c in teng.run()]
    assert got == want and sorted(u for u, _ in got) == list(range(6))


def test_prefill_step_logits_match_jax(models):
    """`make_prefill_step` (serving weights): the encoder over the
    batch's frames, the blockwise decoder; logits at every position as
    the reference's prefill computes them."""
    rcfg, tcfg, rp, model = models
    rserve, serve = _serving(rp, model, tcfg)
    frames, toks = _frames(rcfg, seed=4), _tokens(rcfg, seed=4)
    want = np.asarray(jax.jit(lambda p, f, t: rwhisper.decode_fwd(
        p, t, rwhisper.encode(p, f, rcfg), rcfg, attn_impl="blockwise"))(
            rserve, jnp.asarray(frames), jnp.asarray(toks)).astype(
                jnp.float32))
    step = tsteps.make_prefill_step(tcfg, ShapeSpec("t", "prefill", SEQ,
                                                    BATCH), device="cpu")
    assert step.batch_shapes == {"inputs": (BATCH, SEQ),
                                 "frames": (BATCH, 32, 64)}
    got = step.fn(serve, {"inputs": torch.from_numpy(toks),
                          "frames": torch.from_numpy(frames)})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == want.shape == (BATCH, SEQ, tcfg.vocab)
    assert rel_l2(got, want) <= 5e-2, rel_l2(got, want)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    sstep = tsteps.make_serve_step(tcfg, ShapeSpec("d", "decode", 8, 3),
                                   device="cpu")
    state = sstep.init_state()
    assert tuple(state["cross_k"].shape) == (2, 3, 32, 4, 16)
    logits, state = sstep.fn(serve, state, torch.zeros(3, dtype=torch.int64))
    assert tuple(logits.shape) == (3, tcfg.vocab) and state["pos"] == 1


def test_learned_positions_past_the_table_raise(models):
    """Where the reference clamps a position past `MAX_LEARNED_POS`, the
    port raises, in the forward and in the decode step."""
    _, tcfg, _, model = models
    big = dataclasses.replace(tcfg, n_layers=1)
    with pytest.raises(ValueError, match="learned table"):
        twhisper.decode_fwd(model, torch.zeros(
            (1, tcommon.MAX_LEARNED_POS + 1), dtype=torch.long),
            torch.zeros((1, 32, 64)), big)
    state = twhisper.init_whisper_decode_state(
        tcfg, 1, tcommon.MAX_LEARNED_POS + 2, device="meta")
    with pytest.raises(ValueError, match="learned table"):
        twhisper.whisper_decode_step(
            model, dict(state, pos=tcommon.MAX_LEARNED_POS),
            torch.zeros(1, dtype=torch.long), tcfg)


def test_serving_dtypes_match_to_serving_dtype():
    """Leaf by leaf, the serving weights have the reference's
    `_to_serving_dtype` shapes and dtypes: every stacked layer's vectors
    (norms, attention biases) bf16, `enc_norm` and `dec_norm` float32."""
    for get in ("reduced", "get"):
        rcfg = getattr(rregistry, get)(NAME)
        tcfg = getattr(registry, get)(NAME)
        shapes = rsteps._to_serving_dtype(jax.eval_shape(
            lambda k: rwhisper.init_whisper(k, rcfg), jax.random.key(0)))
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
    for n in ("enc_blocks.0.ln1.scale", "enc_blocks.1.attn.bq",
              "dec_blocks.0.lnx.bias", "dec_blocks.1.attn.bv",
              "dec_blocks.0.xattn.wk", "emb", "pos_emb"):
        assert dtypes[n] == torch.bfloat16, n
    for n in ("enc_norm.scale", "enc_norm.bias", "dec_norm.scale"):
        assert dtypes[n] == torch.float32, n


def test_stacked_rank_rules_cover_the_layer_stacks(models):
    """`lm.stacked_ndim` counts `enc_blocks` and `dec_blocks` as stacked:
    AdamW decays their vectors (the reference's `ndim >= 2` on its
    stacked tree) and not the unstacked norms."""
    _, _, _, model = models
    named = dict(model.named_parameters())
    assert tlm.stacked_ndim("enc_blocks.0.ln1.scale",
                            named["enc_blocks.0.ln1.scale"]) == 2
    assert tlm.stacked_ndim("enc_norm.scale", named["enc_norm.scale"]) == 1
    mask = tadamw._decay_mask(named)
    for n in ("enc_blocks.0.ln2.bias", "dec_blocks.1.attn.bk",
              "dec_blocks.0.lnx.scale", "dec_blocks.0.ffn.wi", "emb",
              "pos_emb"):
        assert mask[n], n
    for n in ("enc_norm.scale", "enc_norm.bias", "dec_norm.bias"):
        assert not mask[n], n


@pytest.mark.parametrize("get", ["get", "reduced"])
def test_count_params_matches_jax(get):
    rcfg = getattr(rregistry, get)(NAME)
    tcfg = getattr(registry, get)(NAME)
    assert tmodels.count_params(tcfg) == rmodels.count_params(rcfg)
    assert tmodels.count_params(tcfg, active_only=True) == \
        rmodels.count_params(rcfg, active_only=True)
    assert tmodels.embedding_params(tcfg) == rmodels.embedding_params(rcfg)
    if get == "get":
        assert tcfg.n_params() == 1_576_998_400


def test_convert_round_trip(models):
    """The `enc_blocks.<i>.*`, `dec_blocks.<i>.*` and unstacked names: the
    reference's tree carried into the port and back with the same
    bits."""
    rcfg, tcfg, rp, model = models
    names = set(model.state_dict())
    assert {"enc_blocks.1.attn.bq", "enc_norm.bias", "emb", "pos_emb",
            "dec_blocks.1.xattn.wo", "dec_blocks.0.lnx.scale",
            "dec_norm.scale"} <= names
    assert not any(n.startswith(("blocks.", "head", "final_norm"))
                   for n in names)
    back = leaves(convert.lm_params_to_numpy(model))
    want = leaves(rp)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert back["['dec_blocks']['xattn']['wk']"].shape == (2, 64, 64)
    assert back["['pos_emb']"].shape == (tcommon.MAX_LEARNED_POS, 64)


def test_configs_registry_and_model_cover_the_family():
    for get in ("get", "reduced"):
        tcfg = getattr(registry, get)("whisper-large-v3")
        rcfg = getattr(rregistry, get)(NAME)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
        assert convert.arch_config_from_dict(dataclasses.asdict(rcfg)) == tcfg
        assert tmodels.build_model(tcfg).cfg == tcfg
        with pytest.raises(ValueError, match="whisper"):
            tlm.check_dense(tcfg)
    assert NAME in registry.PORTED
    assert set(registry.PORTED) == set(rregistry.ARCH_IDS)
    cfg = registry.get(NAME)
    for name in tshapes.SHAPES:
        tb = tshapes.batch_struct(cfg, tshapes.SHAPES[name])
        rb = rshapes.batch_struct(rregistry.get(NAME), rshapes.SHAPES[name])
        assert {k: (v.shape, str(v.dtype).replace("torch.", ""))
                for k, v in tb.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in rb.items()}
        assert tshapes.microbatches_for(cfg, tshapes.SHAPES[name]) == \
            rshapes.microbatches_for(rregistry.get(NAME), rshapes.SHAPES[name])
        assert tshapes.applicable(cfg, tshapes.SHAPES[name]) == \
            rshapes.applicable(rregistry.get(NAME), rshapes.SHAPES[name])
    assert not tshapes.applicable(cfg, tshapes.SHAPES["long_500k"])[0]
    with pytest.raises(ValueError, match="encdec"):
        tmodels.build_model(dataclasses.replace(cfg, encdec=None))


def test_synthetic_batches_carry_frames():
    """`batch_for` adds `frames` (B, enc_frames, D) float32, 0.1 x
    standard normal, a pure function of (seed, step), to the dense
    family's token batches."""
    cfg = registry.reduced(NAME)
    a = synthetic.batch_for(cfg, 32, 4, 3)
    assert set(a) == {"inputs", "targets", "frames"}
    assert a["frames"].dtype == torch.float32
    assert tuple(a["frames"].shape) == (4, 32, 64)
    assert abs(float(a["frames"].std()) - 0.1) < 0.01
    assert torch.equal(a["frames"], synthetic.batch_for(cfg, 32, 4, 3)
                       ["frames"])
    assert not torch.equal(a["frames"], synthetic.batch_for(cfg, 32, 4, 4)
                           ["frames"])
    dense = dataclasses.replace(cfg, family="dense", encdec=None)
    b = synthetic.batch_for(dense, 32, 4, 3)
    for k in ("inputs", "targets"):
        assert torch.equal(a[k], b[k])


def test_train_cli_and_trainer_state(tmp_path):
    """`init_state` builds the encoder-decoder through the registry; the
    launcher trains the reduced config on the CPU (batches with frames)
    and checkpoints it."""
    cfg = registry.reduced(NAME)
    state = init_state(cfg, TrainerConfig(), device="cpu")
    assert isinstance(state["params"], twhisper.Whisper)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "whisper-large-v3", "--reduced", "--device", "cpu", "--steps",
           "3", "--seq", "32", "--batch", "2", "--ckpt-dir", str(tmp_path),
           "--ckpt-every", "2"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "step     0 loss" in out.stdout
    assert (tmp_path / "LATEST").read_text() == "step_00000003"
