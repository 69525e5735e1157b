"""The port's hybrid family (`configs/zamba2_2_7b.py`, `models/mamba2.py`,
the hybrid branches of `models/lm.py`, `models/registry.py`,
`convert.py`, `launch/steps.py`, `launch/shapes.py`, `data/synthetic.py`,
`serve/engine.py`, `optim/adamw.py`) held against the JAX reference on
the CPU.

Model: `zamba2-reduced` (4 Mamba2 layers in 2 groups of 2, d 64, vocab
512; Mamba2 state 8, head dim 16, chunk 16; the shared block's attention
4 heads over 4 KV heads at head dim 16, FFN 128).  Parameters come from
the reference's `init_lm` with the norm scales, `conv_b`, `dt_bias` and
`d_skip` moved off their initial values by numpy draws, carried over by
`convert.lm_params_from_numpy`; tokens are numpy draws.

The backbone is bf16 in both packages (the embedding's cast), so the
arithmetic is held tightly with a float32 backbone set on both sides, as
`tests/test_torch_paligemma.py` does (the reference's `lm.jnp` read
through a stand-in whose `bfloat16` is float32, the port's
`lm.BACKBONE`).  Tolerances:

- `lm_hidden` / `lm_logits`, float32 backbone, dense attention and
  blockwise (the shared block's head dim 16 runs the float32 plain
  version of the 3xTF32 kernel): rtol 1e-5, atol 1e-5 (measured max
  abs 6.7e-6, rel L2 1.1e-6).  bf16 backbone: rel L2 <= 5e-2 (measured
  1.8e-2 to 2.2e-2: four chunked SSDs whose bf16 products and sums
  round at other places in XLA and in PyTorch, against 1.0e-2 for two
  attention layers in `tests/test_torch_prefill.py`).
- `lm_loss` and its grads, float32 backbone: loss rtol 1e-5 (measured
  7.0e-8), each grad leaf rel L2 <= 1e-4 (measured <= 2.6e-6); bf16:
  loss rtol 2e-3 (measured 3.4e-5), each grad leaf rel L2 <= 5e-2
  (measured <= 4.6e-2, the mixer's `a_log`: a sum over every position
  of bf16 products), PR 21's bounds of `lm_loss`.
- One `make_train_step` step at 1 and 2 microbatches, with and without
  remat, against the reference's unjitted composition
  (`value_and_grad(lm_loss)` + `adamw.update`; its jitted step raises
  on this JAX): the bounds of `lm_loss` above, float32 backbone loss
  rtol 1e-5 (measured 7.0e-8), grad norm rtol 1e-4 (9.8e-8), each grad
  leaf (AdamW's first moment, (1 - b1) g) and each updated parameter rel
  L2 <= 1e-4 (2.9e-6, 2.0e-8); bf16 loss rtol 2e-3 (3.4e-5), grad norm
  rtol 2e-2 (2.2e-3), each leaf rel L2 <= 5e-2 (4.6e-2, `a_log` again);
  and the update itself as `tests/test_torch_train.py` holds it: every
  element within 2.2 lr (measured 0.047 lr in float32, 2.03 lr in bf16),
  >= 97 % within 0.1 lr (99.1 % in bf16).  AdamW on the same grads: rtol
  1e-6.
- Group remat: grads equal bit for bit with and without it, and the
  bytes it keeps for backward grow by exactly one (B, S, D) residual a
  group.
- Teacher-forced `decode_step` (serving weights, bf16) against the
  reference's step by step over 12 tokens: rel L2 <= 5e-2 each step
  (measured <= 2.5e-2), argmax equal at every (step, row) whose
  reference top-two gap is at least `NEAR_TIE` (5e-2; the largest logit
  difference measured is 6.6e-2, and 3 of 24 rows, with gaps 3.3e-6 to
  2.0e-2, flip); float32 backbone: rtol 1e-4, atol 1e-4, every argmax
  equal.
- `make_prefill_step` (serving weights): logits rel L2 <= 5e-2, argmax
  equal at >= 90 %.
- `ServeEngine`: completions equal to the reference's, its sampler fed
  the reference's Gumbel draws.
- `count_params`, the serving dtypes, the state-dict names, configs:
  exact.
"""
import contextlib
import dataclasses

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
from repro_torch.optim import adamw as tadamw
from repro_torch.serve import engine as tengine
from repro_torch.train.trainer import TrainerConfig, init_state
from torch_port_helpers import JaxGumbel, ref_train_step  # (one torch
#                                               thread per worker)

NAME = "zamba2_2_7b"
SEQ, BATCH, STEPS, MAX_SEQ = 32, 2, 12, 16
PERTURBED = ("['scale']", "['conv_b']", "['dt_bias']", "['d_skip']")
NEAR_TIE = 5e-2


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _leaves(tree):
    """{keystr: numpy leaf} of a nested dict."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


class _F32Jnp:
    """`jax.numpy` with `bfloat16` read as float32: the reference's `lm`
    module casts the embedding with `astype(jnp.bfloat16)`."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _f32_backbone(monkeypatch, on: bool = True):
    """Both packages' backbones in float32 (when `on`) for the block."""
    if not on:
        yield
        return
    with monkeypatch.context() as m:
        m.setattr(rlm, "jnp", _F32Jnp())
        m.setattr(tlm, "BACKBONE", torch.float32)
        yield


@pytest.fixture(scope="module")
def models():
    """(reference cfg, port cfg, reference params, port LM)."""
    rcfg, tcfg = rregistry.reduced(NAME), registry.reduced(NAME)
    rp = rlm.init_lm(jax.random.key(0), rcfg)
    rng = np.random.default_rng(5)
    rp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.1 * rng.standard_normal(
            a.shape).astype(np.float32))
        if jax.tree_util.keystr(path).endswith(PERTURBED) else a, rp)
    model = tlm.LM(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    return rcfg, tcfg, rp, model


def _tokens(cfg, seed=2, seq=SEQ):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (BATCH, seq))


def _serving(rp, model, tcfg):
    """The serving weights of both: the reference's `_to_serving_dtype`
    rule on its stacked tree (float32 leaves of rank >= 2 to bf16), the
    port's `init_lm(dtype=torch.bfloat16)` placement."""
    rserve = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.dtype == jnp.float32 and a.ndim >= 2 else a, rp)
    serve = tlm.LM(tcfg, torch.Generator(), dtype=torch.bfloat16)
    serve.load_state_dict(model.state_dict())
    return rserve, serve


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["dense", "blockwise"])
def test_lm_hidden_and_logits_match_jax(models, attn_impl, backbone,
                                        monkeypatch):
    """The grouped forward: the shared block, then 2 Mamba2 layers, twice;
    then the untied head."""
    rcfg, tcfg, rp, model = models
    toks = _tokens(rcfg)
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32), torch.no_grad():
        want, _ = rlm.lm_hidden(rp, jnp.asarray(toks), rcfg,
                                attn_impl=attn_impl)
        want_l = rlm.lm_logits(rp, want, rcfg)
        got, aux = tlm.lm_hidden(model, torch.from_numpy(toks), tcfg,
                                 attn_impl=attn_impl)
        got_l = tlm.lm_logits(model, got, tcfg)
    assert float(aux) == 0.0
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    assert got.shape == want.shape == (BATCH, SEQ, rcfg.d_model)
    for g, w in ((got, want), (got_l, want_l)):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        if f32:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert _rel_l2(g, w) <= 5e-2, _rel_l2(g, w)


def test_lm_hidden_runs_the_shared_block_once_a_group(models, monkeypatch):
    """Blockwise: one `flash_attention` call per group, on the shared
    block's q (B, S, 4, 16) (the 3xTF32 route's plain version on the
    CPU); the Mamba2 layers run `mamba2_fwd` once each."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import mamba2 as tmamba

    _, tcfg, _, model = models
    seen, mixers = [], []
    real_fa, real_m = fk.flash_attention_tf32x3, tmamba.mamba2_fwd

    def spy_fa(q, k, v, **kw):
        seen.append(tuple(q.shape))
        return real_fa(q, k, v, **kw)

    def spy_m(p, x, cfg):
        mixers.append(p)
        return real_m(p, x, cfg)

    monkeypatch.setattr(fk, "flash_attention_tf32x3", spy_fa)
    monkeypatch.setattr(tmamba, "mamba2_fwd", spy_m)
    with torch.no_grad():
        tlm.lm_hidden(model, torch.from_numpy(_tokens(tcfg)), tcfg,
                      attn_impl="blockwise")
    assert seen == [(BATCH, SEQ, 4, 16)] * 2
    assert mixers == [b.mamba for b in model.blocks]


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
def test_lm_loss_and_grads_match_jax(models, backbone, monkeypatch):
    rcfg, tcfg, rp, model = models
    toks = np.random.default_rng(7).integers(0, rcfg.vocab, (BATCH, SEQ + 1))
    batch = {"inputs": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32):
        (rl, rm), rg = jax.value_and_grad(
            lambda p, b: rlm.lm_loss(p, b, rcfg), has_aux=True)(
                rp, jax.tree.map(jnp.asarray, batch))
        model.zero_grad(set_to_none=True)
        tl, tm = tlm.lm_loss(model, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, tcfg)
        tl.backward()
    assert set(tm) == set(rm) == {"nll", "z_loss", "ppl_proxy", "aux_loss"}
    np.testing.assert_allclose(float(tl.detach()), float(rl),
                               rtol=1e-5 if f32 else 2e-3)
    got = _leaves(convert.lm_params_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    want = _leaves(rg)
    assert set(got) == set(want)
    assert any("shared" in k for k in want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= (1e-4 if f32 else 5e-2), \
            (k, _rel_l2(got[k], want[k]))


def test_lm_loss_with_remat_is_the_same(models):
    """`remat` (each group, its shared call and Mamba2 layers, under one
    `torch.utils.checkpoint`, each Mamba2 layer under its own inside it)
    changes no bit of the loss or the grads."""
    _, tcfg, _, model = models
    toks = torch.from_numpy(_tokens(tcfg, seed=8))
    batch = {"inputs": toks, "targets": toks.roll(1, dims=1)}
    grads = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss, _ = tlm.lm_loss(model, batch, tcfg, remat=remat)
        loss.backward()
        grads.append((loss.detach(), {n: p.grad.clone()
                                      for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    assert torch.equal(grads[0][0], grads[1][0])
    for n, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][n]), n


def test_init_decode_state_shapes_and_dtypes():
    """Mamba2 states float32, stacked over the 4 layers; one bf16 k / v
    pair per group's shared call, stacked over the 2 groups."""
    cfg = registry.reduced(NAME)
    state = tlm.init_decode_state(cfg, 3, 10, device="cpu")
    got = {f"{part}.{k}": (tuple(v.shape), v.dtype)
           for part in ("caches", "shared_caches")
           for k, v in state[part].items()}
    assert got == {"caches.ssm": ((4, 3, 8, 8, 16), torch.float32),
                   "caches.conv": ((4, 3, 3, 144), torch.float32),
                   "shared_caches.k": ((2, 3, 4, 10, 16), torch.bfloat16),
                   "shared_caches.v": ((2, 3, 4, 10, 16), torch.bfloat16)}
    assert state["pos"] == 0
    rstate = rlm.init_decode_state(rregistry.reduced(NAME), 3, 10)
    want = {f"{part}.{k}": (tuple(v.shape), str(v.dtype))
            for part in ("caches", "shared_caches")
            for k, v in rstate[part].items()}
    assert {k: (s, str(d).replace("torch.", "")) for k, (s, d) in
            got.items()} == want
    big = tlm.init_decode_state(registry.get(NAME), 1, 4, device="meta")
    assert tuple(big["caches"]["ssm"].shape) == (54, 1, 80, 64, 64)
    assert tuple(big["caches"]["conv"].shape) == (54, 1, 3, 5248)
    assert tuple(big["shared_caches"]["k"].shape) == (9, 1, 32, 4, 80)


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
def test_decode_matches_jax(models, backbone, monkeypatch):
    """Teacher-forced `decode_step` (serving weights) against the
    reference's step by step: the grouped scan's shared calls over their
    own caches and the Mamba2 recurrences."""
    rcfg, tcfg, rp, model = models
    rserve, serve = _serving(rp, model, tcfg)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (BATCH, STEPS))
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32):
        rstep = jax.jit(lambda p, s, t: rlm.decode_step(p, s, t, rcfg))
        rstate = rlm.init_decode_state(rcfg, BATCH, MAX_SEQ)
        api = tmodels.build_model(tcfg)
        tstate = api.init_decode_state(BATCH, MAX_SEQ, device="cpu")
        caches = tstate["caches"]["ssm"], tstate["shared_caches"]["k"]
        for t in range(STEPS):
            want, rstate = rstep(rserve, rstate,
                                 jnp.asarray(toks[:, t], jnp.int32))
            got, tstate = api.decode_step(serve, tstate,
                                          torch.from_numpy(toks[:, t]))
            want, got = np.asarray(want), got.numpy()
            if f32:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            else:
                assert _rel_l2(got, want) <= 5e-2, (t, _rel_l2(got, want))
            top2 = np.sort(want, -1)[:, -2:]
            clear = f32 | (top2[:, 1] - top2[:, 0] >= NEAR_TIE)
            assert (got.argmax(-1) == want.argmax(-1))[clear].all(), t
    assert tstate["pos"] == STEPS
    assert tstate["caches"]["ssm"] is caches[0]         # written in place
    assert tstate["shared_caches"]["k"] is caches[1]
    with pytest.raises(ValueError, match="outside the cache"):
        api.decode_step(serve, dict(tstate, pos=MAX_SEQ),
                        torch.zeros(BATCH, dtype=torch.int64))


def test_engine_matches_reference(models):
    """`ServeEngine` serves the reduced zamba2 through `build_model`: six
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
    """`make_prefill_step` (serving weights): logits at every position as
    the reference's (`lm_hidden(attn_impl="blockwise")` + `lm_logits`)."""
    rcfg, tcfg, rp, model = models
    rserve, serve = _serving(rp, model, tcfg)
    toks = _tokens(rcfg, seed=4)
    hidden, _ = rlm.lm_hidden(rserve, jnp.asarray(toks), rcfg,
                              attn_impl="blockwise")
    want = np.asarray(rlm.lm_logits(rserve, hidden, rcfg).astype(jnp.float32))
    step = tsteps.make_prefill_step(tcfg, ShapeSpec("t", "prefill", SEQ,
                                                    BATCH), device="cpu")
    assert step.batch_shapes == {"inputs": (BATCH, SEQ)}
    got = step.fn(serve, {"inputs": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (BATCH, SEQ, tcfg.vocab) == want.shape
    got = got.float().numpy()
    assert _rel_l2(got, want) <= 5e-2, _rel_l2(got, want)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        step.fn(serve, {"inputs": torch.zeros((1, 40), dtype=torch.int64)})


def test_serve_step_is_the_family_decode(models):
    _, tcfg, _, model = models
    step = tsteps.make_serve_step(tcfg, ShapeSpec("t", "decode", 8, 3),
                                  device="cpu")
    state = step.init_state()
    assert tuple(state["shared_caches"]["k"].shape) == (2, 3, 4, 8, 16)
    logits, state = step.fn(model, state, torch.zeros(3, dtype=torch.int64))
    assert tuple(logits.shape) == (3, tcfg.vocab) and state["pos"] == 1


def test_train_step_raises_naming_the_item():
    """The family's train step, which raised naming its ROADMAP item
    while it was not ported, builds and runs: finite loss and grad norm,
    the step and AdamW's count advanced, every parameter moved."""
    tcfg = registry.reduced(NAME)
    step = tsteps.make_train_step(tcfg, device="cpu")
    assert set(step.batch_struct) == {"inputs", "targets"}
    state = init_state(tcfg, TrainerConfig(), device="cpu")
    before = {n: p.detach().clone()
              for n, p in state["params"].named_parameters()}
    state, met = step.fn(state, synthetic.batch_for(tcfg, SEQ, BATCH, 0))
    assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0
    assert int(state["step"]) == 1 and int(state["opt"]["count"]) == 1
    for n, p in state["params"].named_parameters():
        assert not torch.equal(p, before[n]), n


def _train_batch(cfg):
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (BATCH, SEQ + 1))
    return {"inputs": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_composition(models, microbatches, remat,
                                            backbone, monkeypatch):
    """One `make_train_step` step against the reference's
    `value_and_grad(lm_loss)` (with the same `remat`) and
    `adamw.update`: loss, grad norm, every grad leaf (the first moment),
    every updated parameter."""
    rcfg, tcfg, rp, _ = models
    batch = _train_batch(rcfg)
    f32 = backbone == "float32"
    ocfg = radamw.AdamWConfig()
    with _f32_backbone(monkeypatch, f32):
        want_p, want_opt, want_m = ref_train_step(
            lambda p, b: rlm.lm_loss(p, b, rcfg, remat=remat), rp,
            radamw.init(rp, ocfg), batch, microbatches, ocfg)
        state = init_state(tcfg, TrainerConfig(), device="cpu")
        state["params"].load_state_dict(convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, rp)), strict=True)
        step = tsteps.make_train_step(tcfg, microbatches=microbatches,
                                      remat=remat, device="cpu")
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
    got_m = _leaves(convert.opt_state_to_numpy(state["opt"])["m"])
    want_g = _leaves(want_opt["m"])
    got_p = _leaves(convert.lm_params_to_numpy(state["params"]))
    want_p = _leaves(want_p)
    assert set(got_m) == set(want_g) == set(got_p) == set(want_p)
    assert any("shared" in k for k in want_g)
    for k in want_g:
        assert _rel_l2(got_m[k], want_g[k]) <= bound, (k, _rel_l2(
            got_m[k], want_g[k]))
        assert _rel_l2(got_p[k], want_p[k]) <= bound, k
    diff = np.concatenate([np.abs(got_p[k] - want_p[k]).ravel()
                           for k in want_p])
    assert diff.max() <= 2.2 * lr, diff.max() / lr
    assert np.mean(diff <= 0.1 * lr) >= 0.97, np.mean(diff <= 0.1 * lr)


def test_adamw_update_matches_jax_on_the_family_tree(models):
    """The same numpy grads into both AdamW updates at count 100 (lr 3e-4,
    so weight decay shows at rtol 1e-6): the stacked Mamba2 vectors
    (`a_log`, `dt_bias`, `d_skip`: stacked rank 2) decay, the unstacked
    shared block's norm scales and `final_norm.scale` do not."""
    rcfg, tcfg, rp, model = models
    rng = np.random.default_rng(9)
    g = jax.tree.map(lambda a: jnp.asarray(
        0.1 * rng.standard_normal(a.shape).astype(np.float32)), rp)
    rcfgo, tcfgo = radamw.AdamWConfig(), tadamw.AdamWConfig()
    ropt = dict(radamw.init(rp, rcfgo), count=jnp.int32(99))
    rnew, ropt2, rmet = radamw.update(g, ropt, rp, rcfgo)
    tmodel = tlm.LM(tcfg, torch.Generator())
    tmodel.load_state_dict(model.state_dict())
    named = dict(tmodel.named_parameters())
    topt = dict(tadamw.init(named, tcfgo), count=torch.tensor(
        99, dtype=torch.int32))
    _, topt2, tmet = tadamw.update(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, g)), topt, named, tcfgo)
    for k in ("grad_norm", "lr", "clip_scale"):
        np.testing.assert_allclose(float(tmet[k]), float(rmet[k]), rtol=1e-6)
    got, want = _leaves(convert.lm_params_to_numpy(tmodel)), _leaves(rnew)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    for mom in ("m", "v"):
        got = _leaves(convert.opt_state_to_numpy(topt2)[mom])
        for k, w in _leaves(ropt2[mom]).items():
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-9,
                                       err_msg=k)
    mask = tadamw._decay_mask(named)
    for n in ("a_log", "dt_bias", "d_skip", "in_proj"):
        assert mask[f"blocks.0.mamba.{n}"], n
    for n in ("shared.ln1.scale", "shared.ln2.scale", "final_norm.scale"):
        assert not mask[n], n
    assert mask["shared.attn.wq"] and mask["shared.ffn.wi"]


def _saved_bytes(groups: int, remat: bool) -> int:
    """Bytes `lm_loss`'s forward saves for backward (through
    `saved_tensors_hooks`) on the reduced config cut or grown to
    `groups` groups."""
    base = registry.reduced(NAME)
    cfg = dataclasses.replace(
        base, n_layers=groups * base.hybrid.shared_attn_every)
    model = tlm.LM(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg))
    seen = []

    def pack(t):
        seen.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = tlm.lm_loss(model, {"inputs": toks, "targets": toks}, cfg,
                              remat=remat)
    loss.backward()
    return sum(seen)


def test_group_remat_keeps_one_residual_a_group():
    """Under `remat` the forward keeps each group's (B, S, D) bf16 input
    and nothing else of it: 2 more groups add exactly 2 residuals (the
    Mamba2 layers' own checkpoints save their inputs only while the group
    is recomputed; a checkpoint a layer would add 3 a group here).
    Without remat a group keeps every activation of its 3 calls."""
    cfg = registry.reduced(NAME)
    residual = BATCH * SEQ * cfg.d_model * 2
    grown = _saved_bytes(4, True) - _saved_bytes(2, True)
    assert grown == 2 * residual, (grown, residual)
    assert _saved_bytes(4, False) - _saved_bytes(2, False) > \
        2 * (cfg.hybrid.shared_attn_every + 1) * residual


def test_serving_dtypes_match_to_serving_dtype():
    """Leaf by leaf, the port's serving weights have the reference's
    `_to_serving_dtype` shapes and dtypes: the stacked Mamba2 vectors
    (`a_log`, `dt_bias`, `d_skip`, `conv_b`, `norm.scale`) and norm
    scales bf16, the unstacked `shared.ln1.scale`, `shared.ln2.scale` and
    `final_norm.scale` float32."""
    for get in ("reduced", "get"):
        rcfg = getattr(rregistry, get)(NAME)
        tcfg = getattr(registry, get)(NAME)
        want = {jax.tree_util.keystr(p): w for p, w in
                jax.tree_util.tree_flatten_with_path(
                    rsteps._to_serving_dtype(jax.eval_shape(
                        lambda k: rlm.init_lm(k, rcfg),
                        jax.random.key(0))))[0]}
        with torch.device("meta"):
            serve = tlm.LM(tcfg, torch.Generator(), device="meta",
                           dtype=torch.bfloat16)
        specs = jax.tree_util.tree_flatten_with_path(
            convert.train_state_tree({"params": serve}, spec=True)["params"],
            is_leaf=lambda x: isinstance(x, tshapes.TensorSpec))[0]
        got = {jax.tree_util.keystr(p): g for p, g in specs}
        assert set(got) == set(want)
        for k, w in want.items():
            g = got[k]
            assert g.shape == w.shape, k
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), k
    dtypes = {n: p.dtype for n, p in serve.named_parameters()}
    for n in ("a_log", "dt_bias", "d_skip", "conv_b", "norm.scale"):
        assert dtypes[f"blocks.0.mamba.{n}"] == torch.bfloat16, n
    for n in ("shared.ln1.scale", "shared.ln2.scale", "final_norm.scale"):
        assert dtypes[n] == torch.float32, n
    assert dtypes["shared.attn.wq"] == torch.bfloat16


@pytest.mark.parametrize("get", ["get", "reduced"])
def test_count_params_matches_jax(get):
    rcfg = getattr(rregistry, get)(NAME)
    tcfg = getattr(registry, get)(NAME)
    assert tmodels.count_params(tcfg) == rmodels.count_params(rcfg)
    assert tmodels.count_params(tcfg, active_only=True) == \
        rmodels.count_params(rcfg, active_only=True)
    assert tmodels.embedding_params(tcfg) == rmodels.embedding_params(rcfg)
    if get == "get":
        assert tcfg.n_params() == 2_422_670_240


def test_convert_round_trip(models):
    """The `blocks.<i>.mamba.*` and unstacked `shared.*` names: the
    reference's tree carried into the port and back with the same
    bits."""
    rcfg, tcfg, rp, model = models
    names = set(model.state_dict())
    assert {"shared.ln1.scale", "shared.attn.wq", "shared.ffn.wg",
            "blocks.3.mamba.in_proj", "blocks.0.mamba.norm.scale",
            "head"} <= names
    assert not any(n.startswith("shared.") and n.split(".")[1].isdigit()
                   for n in names)
    back = _leaves(convert.lm_params_to_numpy(model))
    want = _leaves(rp)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert back["['shared']['attn']['wq']"].shape == (64, 64)
    assert back["['blocks']['mamba']['a_log']"].shape == (4, 8)


def test_configs_registry_and_model_cover_the_family():
    for get in ("get", "reduced"):
        tcfg = getattr(registry, get)("zamba2-2.7b")
        rcfg = getattr(rregistry, get)(NAME)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
        assert convert.arch_config_from_dict(dataclasses.asdict(rcfg)) == tcfg
        tlm.check_dense(tcfg)
        assert tmodels.build_model(tcfg).cfg == tcfg
        assert tlm.n_stacked_layers(tcfg) == rlm.n_stacked_layers(rcfg)
        acfg = tlm._zamba_attn_cfg(tcfg)
        assert dataclasses.asdict(acfg) == dataclasses.asdict(
            rlm._zamba_attn_cfg(rcfg))
    assert NAME in registry.PORTED
    assert tlm._zamba_attn_cfg(registry.get(NAME)).resolved_head_dim == 80
    cfg = registry.get(NAME)
    for name in tshapes.SHAPES:
        tb = tshapes.batch_struct(cfg, tshapes.SHAPES[name])
        rb = rshapes.batch_struct(rregistry.get(NAME), rshapes.SHAPES[name])
        assert {k: v.shape for k, v in tb.items()} == \
            {k: tuple(v.shape) for k, v in rb.items()}
    for bad in (dict(ssm=None), dict(hybrid=None), dict(n_layers=5)):
        with pytest.raises(ValueError, match="hybrid|groups"):
            tlm.check_dense(dataclasses.replace(cfg, **bad))


def test_long_500k_is_admitted_for_the_family_only():
    """`applicable`: long_500k needs a sub-quadratic config; zamba2 and
    xlstm-125m (the SSM family) are the port configs that are one."""
    shape = tshapes.SHAPES["long_500k"]
    assert shape.seq == 524288 and shape.batch == 1
    for name in registry.PORTED:
        cfg = registry.get(name)
        ok, why = tshapes.applicable(cfg, shape)
        assert (ok, why) == rshapes.applicable(rregistry.get(name),
                                               rshapes.SHAPES["long_500k"])
        assert ok == (name in (NAME, "xlstm_125m")), name
        for other in ("prefill_32k", "decode_32k"):
            assert tshapes.applicable(cfg, tshapes.SHAPES[other])[0]


def test_synthetic_batches_cover_the_family():
    """`batch_for` gives the family the dense family's token batches
    (same vocabulary, seed and step) and nothing else, as the
    reference's."""
    hy = registry.reduced(NAME)
    dense = dataclasses.replace(hy, family="dense", ssm=None, hybrid=None)
    a = synthetic.batch_for(hy, 32, 4, 3)
    assert set(a) == {"inputs", "targets"}
    b = synthetic.batch_for(dense, 32, 4, 3)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["inputs"].shape == (4, 32)
