"""The port's VLM family (`configs/paligemma_3b.py`,
`models/common.prefix_lm_mask`, `models/lm.lm_hidden`'s prefix,
`models/paligemma.py`, `models/registry.py`, `launch/steps.py`,
`data/synthetic.py`, `serve/engine.py`) held against the JAX reference on
the CPU.

Models: `paligemma-reduced` (2 layers, d 64, 4 heads over 1 KV head at
head dim 16, 16 patches, vocab 512, tied embeddings) and the same
widened to the full config's head dim (`WIDE`: d 256, 8 heads over 1 KV
head at 256), whose blockwise attention runs the plain version of the
(256, 256) tensor-core instantiation.  Parameters come from the
reference's `init_lm` (norm scales moved off 1 with numpy draws, so the
scales matter) and are carried over by `convert.lm_params_from_numpy`;
tokens and patches are drawn with numpy.

The backbone is bf16 in both packages (the embedding's cast), so the
arithmetic is held tightly with a float32 backbone set on both sides:
the reference's `lm` module reads `jnp.bfloat16` through a stand-in that
gives float32 (`_f32_backbone`), the port's reads `lm.BACKBONE`.
Tolerances:

- `prefix_lm_mask`: equal.
- `lm_hidden` with `prefix_embeds`, float32 backbone, dense attention
  under `prefix_lm_mask` and blockwise attention with the prefix (the
  reduced config's head dim 16 runs the float32 plain version of the
  3xTF32 kernel; no route takes float32 at 256, so the widened
  blockwise case runs in bf16, below): rtol 1e-5 and atol 1e-5, 1e-5 of
  the final norm's O(1) outputs, for elements near 0 (measured max abs
  5.2e-6, rel L2 <= 1.1e-6).
- The widened config's blockwise `lm_hidden` in bf16 (the (256, 256)
  plain version at its 64-key tile, which rounds P to bf16 as the
  reference's core does, but not the scores nor P.V): rel L2 <= 3e-2 as
  `tests/test_torch_prefill.py` (measured 1.0e-2).
- `paligemma_loss` and its grads, float32 backbone: loss rtol 1e-5
  (measured 2.3e-7), each grad leaf rel L2 <= 1e-4 (measured <= 1.1e-6);
  bf16 backbone: loss rtol 2e-3 (measured 3.7e-5), each grad leaf rel L2
  <= 5e-2 (measured <= 1.2e-2), PR 21's bounds of `lm_loss`.
- One `make_train_step` step against the reference's `value_and_grad`
  and `adamw.update`: PR 21's bounds (`tests/test_torch_train.py`): loss
  rtol 2e-3 (measured 3.7e-5), grad norm rtol 2e-2 (measured 4.4e-4),
  every parameter within 2.2 lr (measured 2.0017 lr: a grad sign flipped
  by the bf16 rounding moves its element 2 lr) and >= 97 % within 0.1 lr
  (measured 99.7 %).
- The prefill step with patches (serving weights): logits at all P + S
  positions rel L2 <= 3e-2, argmax equal at >= 90 % (measured 1.1e-2 and
  1.0e-2, 98.75 %).
- `decode_step` (the reference's decode has no prefix) step by step
  against the reference's on 12 tokens, and against the port's own
  blockwise prefill of the same tokens: rel L2 <= 3e-2 each step
  (measured <= 7.1e-3 and <= 1.1e-2), argmax equal at >= 90 % of (step,
  row) pairs (measured 22 of 24 each), as `tests/test_torch_decode.py`.
- `ServeEngine`: completions equal to the reference's, its sampler fed
  the reference's Gumbel draws.
- `convert` round trip, `count_params`, configs: exact.
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
from repro.models import common as rcommon
from repro.models import lm as rlm
from repro.models import paligemma as rpali
from repro.models import registry as rmodels
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
from repro_torch.models import paligemma as tpali
from repro_torch.models import registry as tmodels
from repro_torch.serve import engine as tengine
from repro_torch.train.trainer import TrainerConfig, init_state
from torch_port_helpers import JaxGumbel  # (one torch thread per worker)

NAME = "paligemma_3b"
WIDE = "paligemma_3b-dh256"
SEQ, BATCH, STEPS, MAX_SEQ = 24, 2, 12, 16


def _cfg(pkg, name):
    """A reduced config of `pkg`'s registry; WIDE is the reduced config
    at the full config's head dim (2 layers, d 256, 8 heads, 1 KV head)."""
    if name == WIDE:
        return dataclasses.replace(pkg.reduced(NAME), d_model=256, n_heads=8,
                                   n_kv_heads=1, head_dim=256)
    return pkg.reduced(name)


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


def _build(name):
    """(reference cfg, port cfg, reference params, port LM)."""
    rcfg, tcfg = _cfg(rregistry, name), _cfg(registry, name)
    rp = rpali.init_paligemma(jax.random.key(0), rcfg)
    rng = np.random.default_rng(5)
    # norm scales off 1, so the norms' parameters carry through
    rp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.1 * rng.standard_normal(
            a.shape).astype(np.float32))
        if jax.tree_util.keystr(path).endswith("['scale']") else a, rp)
    model = tlm.LM(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    return rcfg, tcfg, rp, model


@pytest.fixture(scope="module", params=[NAME, WIDE])
def models(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def reduced():
    return _build(NAME)


def _batch(cfg, seed=2, seq=SEQ):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, seq + 1))
    return {"inputs": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "patches": 0.1 * rng.standard_normal(
                (BATCH, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _serving(rp, model, tcfg):
    """The serving weights of both: stacked rank >= 2 cast to bf16 (the
    reference's `_to_serving_dtype`; `final_norm.scale` stays float32)."""
    rserve = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.dtype == jnp.float32 and a.ndim >= 2 else a, rp)
    serve = tlm.LM(tcfg, torch.Generator(), dtype=torch.bfloat16)
    serve.load_state_dict(model.state_dict())
    return rserve, serve


@pytest.mark.parametrize("s,p", [(10, 4), (8, 0), (6, 6), (5, 9), (40, 16)])
def test_prefix_lm_mask_matches_reference(s, p):
    np.testing.assert_array_equal(tcommon.prefix_lm_mask(s, p).numpy(),
                                  np.asarray(rcommon.prefix_lm_mask(s, p)))


@pytest.mark.parametrize("attn_impl", ["dense", "blockwise"])
def test_lm_hidden_with_prefix_matches_jax(models, attn_impl, monkeypatch):
    """The patches prepended as `prefix_embeds`: dense attention under
    `prefix_lm_mask`, blockwise with `prefix_len` = P."""
    rcfg, tcfg, rp, model = models
    b = _batch(rcfg)
    p, s = rcfg.vlm.n_patches, SEQ
    f32 = not (attn_impl == "blockwise" and tcfg.resolved_head_dim == 256)
    rmask = rcommon.prefix_lm_mask(p + s, p) if attn_impl == "dense" else None
    tmask = tcommon.prefix_lm_mask(p + s, p) if attn_impl == "dense" else None
    with _f32_backbone(monkeypatch, f32), torch.no_grad():
        want, _ = rlm.lm_hidden(rp, jnp.asarray(b["inputs"]), rcfg,
                                mask=rmask,
                                prefix_embeds=jnp.asarray(b["patches"]),
                                attn_impl=attn_impl)
        got, aux = tlm.lm_hidden(model, torch.from_numpy(b["inputs"]), tcfg,
                                 mask=tmask,
                                 prefix_embeds=torch.from_numpy(b["patches"]),
                                 attn_impl=attn_impl)
    assert float(aux) == 0.0
    assert got.shape == want.shape == (BATCH, p + s, rcfg.d_model)
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if f32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _rel_l2(got, want) <= 3e-2, _rel_l2(got, want)


def test_lm_hidden_prefix_reaches_the_kernel_route(monkeypatch):
    """At head dim 256 the blockwise attention goes to the (256, 256)
    tensor-core route with `prefix_len` = P (on the CPU, its plain
    version at the 64-key tile); float32 at 256 has no route."""
    from repro_torch.kernels.flash_attention import kernel as fk

    _, tcfg, _, model = _build(WIDE)
    seen = []
    real = fk.flash_attention_wgmma

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(v.shape), kw["prefix_len"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(fk, "flash_attention_wgmma", spy)
    b = _tbatch(_batch(tcfg))
    with torch.no_grad():
        tlm.lm_hidden(model, b["inputs"], tcfg, prefix_embeds=b["patches"],
                      attn_impl="blockwise")
    p = tcfg.vlm.n_patches
    assert seen == [((BATCH, p + SEQ, 8, 256), (BATCH, p + SEQ, 1, 256),
                     p)] * tcfg.n_layers
    assert fk.route(torch.bfloat16, 256) == "wgmma"
    with _f32_backbone(monkeypatch), pytest.raises(ValueError,
                                                   match="routes"):
        tlm.lm_hidden(model, b["inputs"], tcfg, prefix_embeds=b["patches"],
                      attn_impl="blockwise")
    with pytest.raises(ValueError, match="prefix_embeds"):
        tlm.lm_hidden(model, b["inputs"], tcfg,
                      prefix_embeds=b["patches"][..., :8])


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
def test_paligemma_loss_and_grads_match_jax(reduced, backbone, monkeypatch):
    rcfg, tcfg, rp, model = reduced
    batch = _batch(rcfg)
    f32 = backbone == "float32"
    with _f32_backbone(monkeypatch, f32):
        (rl, rm), rg = jax.value_and_grad(
            lambda p, b: rpali.paligemma_loss(p, b, rcfg), has_aux=True)(
                rp, jax.tree.map(jnp.asarray, batch))
        model.zero_grad(set_to_none=True)
        tl, tm = tpali.paligemma_loss(model, _tbatch(batch), tcfg)
        tl.backward()
    assert set(tm) == set(rm) == {"nll", "z_loss", "ppl_proxy", "aux_loss"}
    np.testing.assert_allclose(float(tl.detach()), float(rl),
                               rtol=1e-5 if f32 else 2e-3)
    got = _leaves(convert.lm_params_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    want = _leaves(rg)
    assert set(got) == set(want) and not any("head" in k for k in want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= (1e-4 if f32 else 5e-2), \
            (k, _rel_l2(got[k], want[k]))


def test_build_model_loss_is_paligemma_loss(reduced):
    """`build_model`'s loss for the family is `paligemma_loss` (remat
    changes no bit), and it reads only the text positions' targets."""
    _, tcfg, _, model = reduced
    batch = _tbatch(_batch(tcfg))
    api = tmodels.build_model(tcfg, remat=True)
    loss, _ = api.loss(model, batch)
    want, _ = tpali.paligemma_loss(model, batch, tcfg)
    assert torch.equal(loss.detach(), want.detach())
    assert tuple(batch["targets"].shape) == (BATCH, SEQ)


def test_train_step_matches_jax_composition(reduced):
    """One `make_train_step` step (remat, one microbatch) against the
    reference's unjitted `value_and_grad(paligemma_loss)` and
    `adamw.update` (its jitted train step raises on this JAX)."""
    rcfg, tcfg, rp, _ = reduced
    batch = _batch(rcfg)
    ocfg = radamw.AdamWConfig()
    (loss, _), grads = jax.value_and_grad(
        lambda p, b: rpali.paligemma_loss(p, b, rcfg), has_aux=True)(
            rp, jax.tree.map(jnp.asarray, batch))
    want_p, _, want_m = radamw.update(grads, radamw.init(rp, ocfg), rp, ocfg)
    state = init_state(tcfg, TrainerConfig(), device="cpu")
    state["params"].load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    step = tsteps.make_train_step(tcfg, device="cpu")
    assert set(step.batch_struct) == {"inputs", "targets", "patches"}
    state, met = step.fn(state, _tbatch(batch))
    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(met["loss"]), float(loss), rtol=2e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=2e-2)
    lr = float(want_m["lr"])
    np.testing.assert_allclose(float(met["lr"]), lr, rtol=1e-6)
    got, want = _leaves(convert.lm_params_to_numpy(state["params"])), \
        _leaves(want_p)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diff.max() <= 2.2 * lr, diff.max() / lr
    assert np.mean(diff <= 0.1 * lr) >= 0.97, np.mean(diff <= 0.1 * lr)


def test_prefill_step_logits_match_jax(models):
    """`make_prefill_step` with patches: logits at all P + S positions,
    as the reference's (`lm_hidden(prefix_embeds=..., attn_impl=
    "blockwise")`, serving weights on both sides)."""
    rcfg, tcfg, rp, model = models
    rserve, serve = _serving(rp, model, tcfg)
    b = _batch(rcfg)
    hidden, _ = rlm.lm_hidden(rserve, jnp.asarray(b["inputs"]), rcfg,
                              prefix_embeds=jnp.asarray(b["patches"]),
                              attn_impl="blockwise")
    want = np.asarray(rlm.lm_logits(rserve, hidden, rcfg).astype(jnp.float32))
    step = tsteps.make_prefill_step(tcfg, ShapeSpec("t", "prefill", SEQ,
                                                    BATCH), device="cpu")
    p = tcfg.vlm.n_patches
    assert step.batch_shapes == {"inputs": (BATCH, SEQ),
                                 "patches": (BATCH, p, tcfg.d_model)}
    got = step.fn(serve, _tbatch(b))
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (BATCH, p + SEQ, tcfg.vocab) == want.shape
    got = got.float().numpy()
    assert _rel_l2(got, want) <= 3e-2, _rel_l2(got, want)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_decode_matches_jax_and_own_prefill(reduced):
    """Teacher-forced `decode_step` (the family's: the generic one, no
    prefix) against the reference's step by step, and against the port's
    blockwise prefill of the same tokens without patches."""
    rcfg, tcfg, rp, model = reduced
    rserve, serve = _serving(rp, model, tcfg)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (BATCH, STEPS))
    rstep = jax.jit(lambda p, s, t: rpali.decode_step(p, s, t, rcfg))
    rstate = rpali.init_decode_state(rcfg, BATCH, MAX_SEQ)
    api = tmodels.build_model(tcfg)
    tstate = api.init_decode_state(BATCH, MAX_SEQ, device="cpu")
    with torch.no_grad():
        hidden, _ = tlm.lm_hidden(serve, torch.from_numpy(toks), tcfg,
                                  attn_impl="blockwise")
        own = tlm.lm_logits(serve, hidden, tcfg).float().numpy()
    agree_ref = agree_own = 0
    for t in range(STEPS):
        want, rstate = rstep(rserve, rstate, jnp.asarray(toks[:, t],
                                                         jnp.int32))
        got, tstate = api.decode_step(serve, tstate,
                                      torch.from_numpy(toks[:, t]))
        want, got = np.asarray(want), got.numpy()
        assert _rel_l2(got, want) <= 3e-2, t
        assert _rel_l2(got, own[:, t]) <= 3e-2, t
        agree_ref += int((got.argmax(-1) == want.argmax(-1)).sum())
        agree_own += int((got.argmax(-1) == own[:, t].argmax(-1)).sum())
    assert tstate["pos"] == STEPS
    assert min(agree_ref, agree_own) >= 0.9 * BATCH * STEPS


def test_engine_matches_reference(reduced):
    """`ServeEngine` serves the reduced paligemma through `build_model`:
    six requests through four slots, two at temperature 0.8 fed the
    reference's draws: the reference's completions."""
    rcfg, tcfg, rp, model = reduced
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


def test_serve_step_is_the_family_decode(reduced):
    """`make_serve_step` for the family: `decode_step` over a fresh state
    of the shape's batch and cache length."""
    _, tcfg, _, model = reduced
    step = tsteps.make_serve_step(tcfg, ShapeSpec("t", "decode", 8, 3),
                                  device="cpu")
    state = step.init_state()
    assert tuple(state["caches"]["k"].shape) == (tcfg.n_layers, 3, 1, 8, 16)
    logits, state = step.fn(model, state, torch.zeros(3, dtype=torch.int64))
    assert tuple(logits.shape) == (3, tcfg.vocab) and state["pos"] == 1


def test_convert_round_trip(reduced):
    """Tied embeddings: no `head` on either side; the reference's tree
    carried into the port and back with the same bits."""
    rcfg, tcfg, rp, model = reduced
    names = set(model.state_dict())
    assert "head" not in names and "emb" in names
    back = _leaves(convert.lm_params_to_numpy(model))
    want = _leaves(rp)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    again = tlm.LM(tcfg, torch.Generator())
    again.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    for n, t in again.state_dict().items():
        assert torch.equal(t, model.state_dict()[n]), n


@pytest.mark.parametrize("get", ["get", "reduced"])
def test_count_params_matches_jax(get):
    rcfg = getattr(rregistry, get)(NAME)
    tcfg = getattr(registry, get)(NAME)
    assert tmodels.count_params(tcfg) == rmodels.count_params(rcfg)
    assert tmodels.count_params(tcfg, active_only=True) == \
        rmodels.count_params(rcfg, active_only=True)
    assert tmodels.embedding_params(tcfg) == rmodels.embedding_params(rcfg)
    if get == "get":
        assert tcfg.n_params() == 2_508_662_784


def test_configs_registry_and_model_cover_the_family():
    for get in ("get", "reduced"):
        tcfg = getattr(registry, get)("paligemma-3b")
        rcfg = getattr(rregistry, get)(NAME)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
        assert convert.arch_config_from_dict(dataclasses.asdict(rcfg)) == tcfg
        tlm.check_dense(tcfg)
        assert tmodels.build_model(tcfg).cfg == tcfg
    assert NAME in registry.PORTED
    cfg = registry.get(NAME)
    for name in tshapes.SHAPES:
        tb = tshapes.batch_struct(cfg, tshapes.SHAPES[name])
        rb = rshapes.batch_struct(rregistry.get(NAME), rshapes.SHAPES[name])
        assert {k: v.shape for k, v in tb.items()} == \
            {k: tuple(v.shape) for k, v in rb.items()}


def test_synthetic_batches_cover_the_family():
    """`batch_for` gives the family token batches (those of the dense
    family with the same vocabulary, seed and step) plus patches of
    0.1 x standard normal, a pure function of (seed, step)."""
    vlm = registry.reduced(NAME)
    dense = dataclasses.replace(vlm, family="dense", vlm=None)
    a = synthetic.batch_for(vlm, 32, 4, 3)
    assert set(a) == {"inputs", "targets", "patches"}
    tokens = synthetic.batch_for(dense, 32, 4, 3)
    for k in ("inputs", "targets"):
        assert torch.equal(a[k], tokens[k])
    assert a["patches"].shape == (4, vlm.vlm.n_patches, vlm.d_model)
    assert a["patches"].dtype == torch.float32
    assert torch.equal(a["patches"], synthetic.batch_for(vlm, 32, 4, 3)[
        "patches"])
    assert not torch.equal(a["patches"], synthetic.batch_for(vlm, 32, 4, 4)[
        "patches"])
    big = synthetic.batch_for(vlm, 8, 64, 0)["patches"]
    assert abs(float(big.std()) - 0.1) < 5e-3 and abs(float(big.mean())) < 5e-3
