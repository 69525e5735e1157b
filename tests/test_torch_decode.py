"""The port's single-token decode and serving engine held against the JAX
reference on the CPU, on `qwen2.5-reduced` (2 layers, d 64, 4 heads over
2 KV heads, head dim 16, vocab 512).

Parameters come from the reference's `init_lm` (with non-zero QKV
biases) and are carried over by `convert.lm_params_from_numpy`; inputs
are drawn with numpy.  Tolerances:

- `attention_decode`, step by step over 12 tokens at batch 2: float32
  params, activations and cache, atol = rtol = 1e-5 on outputs and
  caches (measured <= 2.4e-7); bfloat16, rel L2 <= 1e-2 on the outputs
  and caches within one bf16 ulp (measured equal).
- `decode_step` over 12 tokens: the embedding is cast to bf16 in both
  packages, so the whole backbone is bf16 with float32 or bf16 params
  alike, and XLA and torch round bf16 products apart here and there:
  logits rel L2 <= 3e-2 each step (measured <= 1.2e-2), argmax equal at
  >= 90 % of (step, row) pairs (measured 100 %).
- The port's decode under teacher forcing against its own prefill
  (`make_prefill_step`, blockwise attention) on the same 12 tokens:
  rel L2 <= 3e-2 (measured <= 1.1e-2), argmax equal at >= 90 %
  (measured 100 %).
- `ServeEngine`: greedy completions equal to the reference's
  `ServeEngine` on the same params and requests; temperature
  completions equal when the port's sampler is fed the reference's
  `jax.random.gumbel` draws under its key splits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro.serve import engine as rengine
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.registry import build_model
from repro_torch.serve import engine as tengine
from torch_port_helpers import JaxGumbel  # (one torch thread per worker)

NAME = "qwen2_5_3b"
BATCH, STEPS, MAX_SEQ = 2, 12, 16


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def models():
    """(reference cfg, port cfg, reference params, port LM)."""
    rcfg, tcfg = rregistry.reduced(NAME), registry.reduced(NAME)
    rp = rlm.init_lm(jax.random.key(0), rcfg)
    rng = np.random.default_rng(5)
    attn = dict(rp["blocks"]["attn"])
    for k in ("bq", "bk", "bv"):
        attn[k] = jnp.asarray(0.1 * rng.standard_normal(
            attn[k].shape).astype(np.float32))
    rp = {**rp, "blocks": {**rp["blocks"], "attn": attn}}
    model = tlm.LM(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    return rcfg, tcfg, rp, model


def _bf16_params(rp, model, tcfg):
    """The serving dtype: matrices bf16, norms and biases float32."""
    rpb = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2
                       else a, rp)
    mb = tlm.LM(tcfg, torch.Generator().manual_seed(0))
    mb.load_state_dict(model.state_dict())
    for prm in mb.parameters():
        if prm.dim() >= 2:
            prm.data = prm.data.to(torch.bfloat16)
    return rpb, mb


def _tokens(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, STEPS))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_matches_jax(models, dtype):
    rcfg, tcfg, rp, model = models
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    p0 = jax.tree.map(lambda a: a[0], rp["blocks"]["attn"])
    rcache = rattn.init_kv_cache(rcfg, BATCH, MAX_SEQ, dtype=jdt)
    tcache = tattn.init_kv_cache(tcfg, BATCH, MAX_SEQ, dtype=tdt,
                                 device="cpu")
    rng = np.random.default_rng(4)
    for t in range(STEPS):
        x = rng.standard_normal((BATCH, rcfg.d_model)).astype(np.float32)
        want, rcache = rattn.attention_decode(p0, jnp.asarray(x, jdt), rcache,
                                              jnp.int32(t), rcfg)
        with torch.no_grad():
            got, tcache = tattn.attention_decode(
                model.blocks[0].attn, torch.from_numpy(x).to(tdt), tcache, t,
                tcfg)
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        for k in ("k", "v"):
            rc = np.asarray(rcache[k].astype(jnp.float32))
            tc = tcache[k].float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(tc, rc, atol=1e-5, rtol=1e-5)
            else:
                ulp = np.spacing(np.abs(rc).astype(jnp.bfloat16)).astype(
                    np.float32)
                assert (np.abs(tc - rc) <= ulp).all(), (t, k)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            assert _rel_l2(got, want) <= 1e-2, t


@pytest.mark.parametrize("params", ["float32", "bfloat16"])
def test_decode_step_matches_jax(models, params):
    rcfg, tcfg, rp, model = models
    if params == "bfloat16":
        rp, model = _bf16_params(rp, model, tcfg)
    toks = _tokens(rcfg)
    step = jax.jit(lambda p, s, t: rlm.decode_step(p, s, t, rcfg))
    rstate = rlm.init_decode_state(rcfg, BATCH, MAX_SEQ)
    tstate = tlm.init_decode_state(tcfg, BATCH, MAX_SEQ, device="cpu")
    agree = 0
    for t in range(STEPS):
        want, rstate = step(rp, rstate, jnp.asarray(toks[:, t], jnp.int32))
        got, tstate = tlm.decode_step(model, tstate,
                                      torch.from_numpy(toks[:, t]), tcfg)
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel_l2(got.numpy(), want) <= 3e-2, t
        agree += int((got.numpy().argmax(-1) == want.argmax(-1)).sum())
        assert tstate["pos"] == int(rstate["pos"]) == t + 1
    assert agree >= 0.9 * BATCH * STEPS
    assert tuple(tstate["caches"]["k"].shape) == \
        tuple(rstate["caches"]["k"].shape)
    assert _rel_l2(tstate["caches"]["v"].float().numpy(),
                   np.asarray(rstate["caches"]["v"].astype(jnp.float32))) \
        <= 3e-2


def test_decode_matches_own_prefill(models):
    """Teacher forcing: the decode's logits at each position are the
    prefill's over the same sequence."""
    _, tcfg, _, model = models
    toks = torch.from_numpy(_tokens(tcfg))
    step = make_prefill_step(tcfg, ShapeSpec("t", "prefill", STEPS, BATCH),
                             device="cpu")
    want = step.fn(model, {"inputs": toks}).float().numpy()
    state = tlm.init_decode_state(tcfg, BATCH, MAX_SEQ, device="cpu")
    agree = 0
    for t in range(STEPS):
        got, state = tlm.decode_step(model, state, toks[:, t], tcfg)
        assert _rel_l2(got.numpy(), want[:, t]) <= 3e-2, t
        agree += int((got.numpy().argmax(-1) == want[:, t].argmax(-1)).sum())
    assert agree >= 0.9 * BATCH * STEPS


def test_decode_step_refuses_a_full_cache(models):
    _, tcfg, _, model = models
    state = tlm.init_decode_state(tcfg, 1, 2, device="cpu")
    tok = torch.zeros(1, dtype=torch.int64)
    for _ in range(2):
        _, state = tlm.decode_step(model, state, tok, tcfg)
    with pytest.raises(ValueError, match="outside the cache"):
        tlm.decode_step(model, state, tok, tcfg)


def _requests(module, cfg):
    """Six requests through four slots: prompts of 3-8 seeded ids,
    max_new 4-8, two at temperature 0.8."""
    rng = np.random.default_rng(11)
    out = []
    for uid in range(6):
        prompt = [int(x) for x in rng.integers(1, cfg.vocab,
                                               int(rng.integers(3, 9)))]
        out.append(module.Request(uid, prompt,
                                  max_new=int(rng.integers(4, 9)),
                                  temperature=0.8 if uid in (2, 5) else 0.0))
    return out


@pytest.fixture(scope="module")
def reference_completions(models):
    rcfg, _, rp, _ = models
    eng = rengine.ServeEngine(rcfg, rp, slots=4, max_seq=64, seed=0)
    for r in _requests(rengine, rcfg):
        eng.submit(r)
    return [(c.uid, c.tokens) for c in eng.run()]


def _port_completions(models, **kw):
    _, tcfg, _, model = models
    eng = tengine.ServeEngine(tcfg, model, slots=4, max_seq=64, seed=0,
                              device="cpu", **kw)
    for r in _requests(tengine, tcfg):
        eng.submit(r)
    return [(c.uid, c.tokens) for c in eng.run()]


def test_engine_matches_reference(models, reference_completions):
    """Greedy and temperature requests alike, the sampler fed the
    reference's draws: the same completions in the same order."""
    got = _port_completions(models, noise=JaxGumbel(0))
    assert got == reference_completions
    assert sorted(uid for uid, _ in got) == list(range(6))


def test_engine_greedy_without_reference_draws(models,
                                               reference_completions):
    """The engine's own Gumbel draws change the sampled requests only;
    one seed gives the same completions twice."""
    got = _port_completions(models)
    assert got == _port_completions(models)
    sampled = {2, 5}
    assert [c for c in got if c[0] not in sampled] == \
        [c for c in reference_completions if c[0] not in sampled]


def test_sample_is_gumbel_argmax():
    logits = torch.tensor([0.0, 2.0, 1.0, 2.0])
    assert tengine.sample(logits, 0.0) == 1           # first of the ties
    g = torch.tensor([0.0, 0.0, 5.0, 0.0])
    assert tengine.sample(logits, 0.5, g) == 2
    assert tengine.sample(logits, 1e9, torch.tensor([0.0, 0.0, 0.0, 1.0])) \
        == 3


def test_build_model_raises_for_families_not_ported():
    for name in ("whisper_large_v3", "paligemma_3b", "zamba2_2_7b",
                 "xlstm_125m", "granite_34b"):
        cfg = convert.arch_config_from_dict(
            dataclasses.asdict(rregistry.reduced(name)))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(cfg)
    api = build_model(registry.reduced(NAME))
    params = api.init(seed=0, device="cpu")
    state = api.init_decode_state(1, 4, device="cpu")
    logits, state = api.decode_step(params, state,
                                    torch.zeros(1, dtype=torch.int64))
    assert tuple(logits.shape) == (1, 512) and state["pos"] == 1
