"""The dense family's last two configs, codeqwen1.5-7b (MHA with QKV
bias, RoPE) and granite-34b (learned absolute positions `pos_emb`,
LayerNorm, the non-gated GELU MLP with biases, MQA), held against the
JAX reference on the CPU: `configs/{codeqwen1_5_7b,granite_34b}.py`,
the learned positions of `models/lm.py` (`LM.pos_emb`, `lm_hidden`,
`decode_step`), `convert.py`, the serving cast, AdamW's decay mask and
`launch/steps.make_train_step`.

Models: `codeqwen-reduced` (2 layers, d 64, 4 heads over 4 KV heads at
head dim 16, vocab 512) and `granite-reduced` (the same over 1 KV head,
d_ff 128, a 32768 x 64 position table).  Parameters come from the
reference's `init_lm` with every norm scale and bias moved off its
initial value by numpy draws, carried over by
`convert.lm_params_from_numpy`; tokens are numpy draws.

The backbone is bf16 in both packages (the embedding's cast), so the
arithmetic is held tightly with a float32 backbone set on both sides,
as `tests/test_torch_zamba2.py` does.  Tolerances:

- `lm_hidden` / `lm_logits`, dense attention and blockwise (head dim 16:
  the float32 plain version of the 3xTF32 kernel), float32 backbone:
  rtol 1e-5, atol 1e-5 (measured max abs 3.1e-6); bf16: rel L2 <= 3e-2
  (measured 1.1e-2), as `tests/test_torch_prefill.py`.
- `lm_loss` and its grads, float32 backbone: loss rtol 1e-5 (measured
  7.2e-8), each grad leaf rel L2 <= 1e-4 (1.2e-6); bf16: loss rtol 2e-3
  (1.7e-4), each leaf rel L2 <= 5e-2 (1.9e-2) (the bounds of
  `tests/test_torch_train.py`).  granite's key bias has no RoPE after it, so its grad is 0
  in exact arithmetic (measured 6.5e-9 and 7.2e-5 at most): both sides
  within 1e-7 (float32) or 1e-3 (bf16) of 0.
- Teacher-forced `decode_step` (serving weights) against the
  reference's step by step over 12 tokens at batch 2: float32 backbone
  and caches rtol 1e-4, atol 1e-4 (measured max abs 1.8e-6), every
  argmax equal; bf16 rel L2 <= 3e-2 each step (9.6e-3) and argmax equal
  at >= 90 % of (step, row) pairs (100 %), as `tests/test_torch_decode.py`.
- `make_prefill_step` (serving weights): rel L2 <= 3e-2 (1.1e-2),
  argmax equal at >= 90 % (98.4 %).
- One `make_train_step` step of `granite-reduced` against the
  reference's unjitted `value_and_grad(lm_loss)` + `adamw.update` (the
  reduced config's float32 moments; the full config's are bf16): the
  bounds of `tests/test_torch_train.py` (loss rtol 2e-3, grad norm rtol
  2e-2, every element within 2.2 lr, >= 97 % within 0.1 lr).  The full
  configs' training waits for sharding.
- Configs, parameter counts, serving dtypes, the decay mask, the
  weights carried both ways: exact.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.launch import steps as rsteps
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import steps as tsteps
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import registry as tmodels
from repro_torch.optim import adamw as tadamw
from repro_torch.train.trainer import TrainerConfig, init_state
from torch_port_helpers import ref_train_step  # (one torch thread per worker)

NAMES = ("codeqwen1_5_7b", "granite_34b")
SEQ, BATCH, STEPS, MAX_SEQ = 32, 2, 12, 16
PERTURBED = ("['scale']", "['bias']", "['bq']", "['bk']", "['bv']",
             "['bi']", "['bo']")


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
def _f32_backbone(monkeypatch, on: bool):
    """Both packages' backbones in float32 (when `on`) for the block."""
    if not on:
        yield
        return
    with monkeypatch.context() as m:
        m.setattr(rlm, "jnp", _F32Jnp())
        m.setattr(tlm, "BACKBONE", torch.float32)
        yield


@pytest.fixture(scope="module", params=NAMES)
def models(request):
    """(reference cfg, port cfg, reference params, port LM) of one
    config's REDUCED variant."""
    rcfg, tcfg = rregistry.reduced(request.param), registry.reduced(
        request.param)
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


def _tokens(cfg, seed=2, shape=(BATCH, SEQ)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _serving(rp, model, tcfg):
    """The serving weights of both: the reference's `_to_serving_dtype`
    rule (float32 leaves of rank >= 2 to bf16), the port's `LM(dtype=
    torch.bfloat16)` placement."""
    rserve = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.dtype == jnp.float32 and a.ndim >= 2 else a, rp)
    serve = tlm.LM(tcfg, torch.Generator(), dtype=torch.bfloat16)
    serve.load_state_dict(model.state_dict())
    return rserve, serve


@pytest.mark.parametrize("name", NAMES)
def test_configs_equal_reference(name):
    for get in ("get", "reduced"):
        tcfg = getattr(registry, get)(name.replace("_", "-"))
        rcfg = getattr(rregistry, get)(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
        assert convert.arch_config_from_dict(dataclasses.asdict(rcfg)) == tcfg
        tlm.check_dense(tcfg)
        assert tmodels.build_model(tcfg).cfg == tcfg
        bf16 = name == "granite_34b" and get == "get"
        assert tsteps.default_opt_cfg(tcfg) == tadamw.AdamWConfig(
            moment_dtype=torch.bfloat16 if bf16 else torch.float32)
    assert name in registry.PORTED
    assert len(registry.PORTED) == 10


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["dense", "blockwise"])
def test_lm_hidden_and_logits_match_jax(models, attn_impl, backbone,
                                        monkeypatch):
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
    for g, w in ((got, want), (got_l, want_l)):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape
        if f32:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert _rel_l2(g, w) <= 3e-2, _rel_l2(g, w)


def test_learned_positions_enter_the_forward():
    """granite's hidden states move when `pos_emb` does (the table is
    read), and only its first S rows get a gradient."""
    tcfg = registry.reduced("granite_34b")
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg))
    with torch.no_grad():
        a, _ = tlm.lm_hidden(model, toks, tcfg)
        model.pos_emb[3].add_(1.0)
        b, _ = tlm.lm_hidden(model, toks, tcfg)
    moved = (a - b).abs().amax(dim=(0, 2))
    assert bool((moved[3:] > 0).all()) and not bool(moved[:3].any())
    loss, _ = tlm.lm_loss(model, {"inputs": toks, "targets": toks}, tcfg)
    loss.backward()
    assert bool(model.pos_emb.grad[:SEQ].abs().sum(-1).gt(0).all())
    assert not bool(model.pos_emb.grad[SEQ:].any())


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
def test_lm_loss_and_grads_match_jax(models, backbone, monkeypatch):
    rcfg, tcfg, rp, model = models
    toks = _tokens(rcfg, seed=7, shape=(BATCH, SEQ + 1))
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
    assert set(tm) == set(rm)
    np.testing.assert_allclose(float(tl.detach()), float(rl),
                               rtol=1e-5 if f32 else 2e-3)
    got = _leaves(convert.lm_params_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}))
    model.zero_grad(set_to_none=True)
    want = _leaves(rg)
    assert set(got) == set(want)
    assert ("['pos_emb']" in want) == (rcfg.pos == "learned")
    for k in want:
        if rcfg.pos != "rope" and k.endswith("['bk']"):
            # without RoPE the key bias adds one constant to each query's
            # scores, which the softmax ignores: its grad is 0 but for
            # rounding on both sides
            zero = 1e-7 if f32 else 1e-3
            assert np.abs(got[k]).max() <= zero >= np.abs(want[k]).max(), k
            continue
        assert _rel_l2(got[k], want[k]) <= (1e-4 if f32 else 5e-2), \
            (k, _rel_l2(got[k], want[k]))


@pytest.mark.parametrize("backbone", ["float32", "bfloat16"])
def test_decode_matches_jax(models, backbone, monkeypatch):
    """Teacher-forced `decode_step` (serving weights) against the
    reference's step by step: granite adds `pos_emb[pos]` each step.
    With the float32 backbone both caches are float32 too."""
    rcfg, tcfg, rp, model = models
    rserve, serve = _serving(rp, model, tcfg)
    toks = _tokens(rcfg, seed=3, shape=(BATCH, STEPS))
    f32 = backbone == "float32"
    agree = 0
    with _f32_backbone(monkeypatch, f32):
        rstep = jax.jit(lambda p, s, t: rlm.decode_step(p, s, t, rcfg))
        rstate = rlm.init_decode_state(rcfg, BATCH, MAX_SEQ)
        if f32:
            rstate = jax.tree.map(lambda a: a.astype(jnp.float32)
                                  if a.dtype == jnp.bfloat16 else a, rstate)
        tstate = tlm.init_decode_state(
            tcfg, BATCH, MAX_SEQ, device="cpu",
            dtype=torch.float32 if f32 else torch.bfloat16)
        for t in range(STEPS):
            want, rstate = rstep(rserve, rstate,
                                 jnp.asarray(toks[:, t], jnp.int32))
            got, tstate = tlm.decode_step(serve, tstate,
                                          torch.from_numpy(toks[:, t]), tcfg)
            want, got = np.asarray(want), got.numpy()
            if f32:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
                assert (got.argmax(-1) == want.argmax(-1)).all(), t
            else:
                assert _rel_l2(got, want) <= 3e-2, (t, _rel_l2(got, want))
            agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    assert agree >= 0.9 * STEPS * BATCH
    assert tstate["pos"] == STEPS


def test_prefill_step_logits_match_jax(models):
    """`make_prefill_step` (serving weights): logits at every position as
    the reference's (`lm_hidden(attn_impl="blockwise")` + `lm_logits`)."""
    rcfg, tcfg, rp, model = models
    rserve, serve = _serving(rp, model, tcfg)
    toks = _tokens(rcfg)
    hidden, _ = rlm.lm_hidden(rserve, jnp.asarray(toks), rcfg,
                              attn_impl="blockwise")
    want = np.asarray(rlm.lm_logits(rserve, hidden, rcfg).astype(jnp.float32))
    step = tsteps.make_prefill_step(tcfg, ShapeSpec("t", "prefill", SEQ,
                                                    BATCH), device="cpu")
    got = step.fn(serve, {"inputs": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    got = got.float().numpy()
    assert _rel_l2(got, want) <= 3e-2, _rel_l2(got, want)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_learned_positions_past_the_table_raise():
    """A prefill longer than MAX_LEARNED_POS and a decode at a position
    past it raise, where the cache itself would take the position."""
    tcfg = registry.reduced("granite_34b")
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    n = tcommon.MAX_LEARNED_POS
    assert n == rlm.common.MAX_LEARNED_POS == 32768
    assert tuple(model.pos_emb.shape) == (n, tcfg.d_model)
    with pytest.raises(ValueError, match="learned table"):
        tlm.lm_hidden(model, torch.zeros((1, n + 1), dtype=torch.int64),
                      tcfg, attn_impl="blockwise")
    state = tlm.init_decode_state(tcfg, 1, n + 2, device="cpu")
    with pytest.raises(ValueError, match="learned table"):
        tlm.decode_step(model, dict(state, pos=n),
                        torch.zeros(1, dtype=torch.int64), tcfg)
    logits, _ = tlm.decode_step(model, dict(state, pos=n - 1),
                                torch.zeros(1, dtype=torch.int64), tcfg)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("name", NAMES)
def test_serving_dtypes_match_reference(name):
    """Leaf by leaf, the port's bf16 serving tree has the dtype the
    reference's `_to_serving_dtype` gives its `init_lm` tree: `pos_emb`
    (rank 2) bf16, `final_norm`'s scale and bias float32."""
    rcfg, tcfg = rregistry.reduced(name), registry.reduced(name)
    want = rsteps._to_serving_dtype(jax.eval_shape(
        lambda: rlm.init_lm(jax.random.key(0), rcfg)))
    serve = tlm.init_lm(tcfg, seed=0, device="cpu", dtype=torch.bfloat16)
    got = convert.train_state_tree({"params": serve}, spec=True)["params"]
    want = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {jax.tree_util.keystr(p): (tuple(v.shape),
                                     str(v.dtype).split(".")[-1])
           for p, v in jax.tree_util.tree_flatten_with_path(
               got, is_leaf=lambda x: hasattr(x, "dtype"))[0]}
    assert got == want
    assert want["['final_norm']['scale']"][1] == "float32"
    if name == "granite_34b":
        assert serve.pos_emb.dtype == torch.bfloat16
        assert want["['pos_emb']"] == ((32768, 64), "bfloat16")


def test_decay_mask_covers_pos_emb():
    """AdamW decays `pos_emb` (rank 2, as the reference's `ndim >= 2`
    rule) and every layer's LayerNorm bias (stacked rank 2), not the
    final norm's scale or bias."""
    tcfg = registry.reduced("granite_34b")
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    mask = tadamw._decay_mask(dict(model.named_parameters()))
    assert mask["pos_emb"] and mask["emb"] and mask["head"]
    assert mask["blocks.0.ln1.bias"] and mask["blocks.1.ffn.bo"]
    assert not mask["final_norm.scale"] and not mask["final_norm.bias"]
    rp = jax.eval_shape(lambda: rlm.init_lm(jax.random.key(0), rregistry
                                            .reduced("granite_34b")))
    want = {k: v.ndim >= 2 for k, v in _leaves(jax.tree.map(
        lambda s: np.zeros(s.shape, np.int8), rp)).items()}
    got = _leaves(convert.lm_params_to_numpy(
        {n: torch.tensor(float(m)).expand(p.shape)
         for (n, p), m in zip(model.named_parameters(), mask.values())}))
    assert {k: bool(v.all()) for k, v in got.items()} == want


def test_convert_round_trip(models):
    """The reference's tree into the port and back with the same bits,
    `pos_emb` included."""
    rcfg, tcfg, rp, model = models
    back = _leaves(convert.lm_params_to_numpy(model))
    want = _leaves(rp)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    again = tlm.LM(tcfg, torch.Generator())
    again.load_state_dict(convert.lm_params_from_numpy(
        convert.lm_params_to_numpy(model)), strict=True)
    for n, p in model.named_parameters():
        assert torch.equal(p, dict(again.named_parameters())[n]), n


def test_train_step_matches_jax_composition():
    """One `make_train_step` step of `granite-reduced` (remat) against the reference's unjitted
    `value_and_grad(lm_loss)` and `adamw.update`."""
    rcfg = rregistry.reduced("granite_34b")
    tcfg = registry.reduced("granite_34b")
    rp = rlm.init_lm(jax.random.key(1), rcfg)
    toks = _tokens(rcfg, seed=9, shape=(4, SEQ + 1))
    batch = {"inputs": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    ocfg = rsteps.default_opt_cfg(rcfg)
    want_p, _, want_m = ref_train_step(
        lambda p, b: rlm.lm_loss(p, b, rcfg), rp, radamw.init(rp, ocfg),
        batch, 1, ocfg)
    state = init_state(tcfg, TrainerConfig(), device="cpu")
    state["params"].load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    step = tsteps.make_train_step(tcfg, device="cpu")
    state, met = step.fn(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), float(want_m["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=2e-2)
    lr = float(want_m["lr"])
    got, want = _leaves(convert.lm_params_to_numpy(state["params"])), \
        _leaves(want_p)
    assert set(got) == set(want) and "['pos_emb']" in want
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diff.max() <= 2.2 * lr, diff.max() / lr
    assert np.mean(diff <= 0.1 * lr) >= 0.97, np.mean(diff <= 0.1 * lr)
