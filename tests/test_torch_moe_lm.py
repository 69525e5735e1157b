"""The port's MoE family as a whole model (`models/lm.py`,
`models/registry.py`, `convert.py`, `launch/steps.py`, `serve/engine.py`)
held against the JAX reference on the CPU.

Models: the reduced deepseek-v2-lite (2 layers, d 64, 4 heads, MLA
kv_lora 32 with (nope + rope, v) = (24, 16), 8 experts top-2 plus a
shared one), the reduced arctic (2 layers, d 64, 4 heads over 2 KV heads
at head dim 16, 8 experts top-2 plus a dense residual FFN), and the
reduced deepseek-v2-lite with the full config's MLA head dims (q/k 192,
v 128): the blockwise prefill runs on a flash attention route only, and
no route takes (24, 16), so the prefill of the reduced deepseek raises
and its prefill is held on the widened one.  Parameters come from the
reference's `init_lm` and are carried over by `convert`; tokens are
drawn with numpy.  Tolerances (the reference's backbone is bf16 whatever
the parameters' dtype, and XLA and torch round bf16 products apart here
and there; where a token's router gap, its k-th minus its (k+1)-th
probability, is under NEAR_TIE such a rounding can flip a claim, which
moves that token's output by up to rel 0.3, and under the config's
capacity the flip also moves the later claims of its group in their
queues, so other tokens' drops change too; flips were measured at gaps
up to 2.7e-3):

- `lm_hidden` (dense attention), all positions: rel L2 <= 3e-2
  (measured <= 2.75e-2, router flips included); the summed aux loss
  rtol 1e-2 (measured <= 1.3e-3); `lm_logits` of one hidden state rtol
  1e-4 (measured equal).
- The prefill step (blockwise attention, serving weights): tokens whose
  routes are decisive (gap >= NEAR_TIE at every layer) >= 85 % (measured
  >= 90.6 %); with a capacity that drops nothing, each decisive
  position's logits within rel L2 DECISIVE_RTOL = 5e-2 (measured <=
  3.4e-2), with the config's capacity >= 85 % of all positions within it
  (measured >= 94.5 %); median rel L2 <= 2e-2 (measured <= 1.34e-2);
  argmax equal at >= 90 % of positions (measured >= 96.1 %).
- `lm_loss` with float32 parameters: loss rtol 1e-3 (measured 7.4e-4),
  `aux_loss` rtol 1e-2 (measured 1.8e-3).
- Teacher-forced `decode_step` against the reference's over 16
  positions at batch 2 (a step's B tokens are one group, never past its
  capacity): decisive (step, row) pairs within DECISIVE_RTOL (measured
  <= 1.8e-2), near ties <= 15 % (measured <= 6.3 %), argmax equal at
  >= 90 % (measured >= 96.9 %).  Against the port's own prefill:
  positions decisive on both sides (>= 80 %, measured 84.4 %) within
  DECISIVE_RTOL (measured <= 1.9e-2), argmax >= 90 % (measured 96.9 %).
- `ServeEngine` on the reduced deepseek: completions equal to the
  reference's, the sampler fed the reference's Gumbel draws.
- `convert` round trips and `count_params`: exact.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.models import registry as rmodels
from repro.serve import engine as rengine
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.models import registry as tmodels
from repro_torch.serve import engine as tengine
from repro_torch.train.trainer import TrainerConfig, init_state
from torch_port_helpers import JaxGumbel  # (one torch thread per worker)

SEQ, BATCH, STEPS, MAX_SEQ = 64, 2, 16, 16
WIDE = "deepseek_v2_lite_16b-mla192"
NEAR_TIE = 3e-3     # router gap under which a bf16 rounding may flip top-k
DECISIVE_RTOL = 5e-2  # rel L2 of a position whose routes are decisive


def _cfg(pkg, name):
    """A reduced config of `pkg`'s registry; WIDE is the reduced deepseek
    with the full config's MLA head dims."""
    if name == WIDE:
        cfg = pkg.reduced("deepseek_v2_lite_16b")
        return dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, rope_dim=64, nope_dim=128, v_dim=128))
    return pkg.reduced(name)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _build(name):
    rcfg, tcfg = _cfg(rregistry, name), _cfg(registry, name)
    rp = rlm.init_lm(jax.random.key(0), rcfg)
    model = tlm.LM(tcfg, torch.Generator())
    model.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    return rcfg, tcfg, rp, model.requires_grad_(False)


@pytest.fixture(scope="module",
                params=["deepseek_v2_lite_16b", "arctic_480b", WIDE])
def models(request):
    """(reference cfg, port cfg, reference params, port LM)."""
    return _build(request.param)


@pytest.fixture(scope="module", params=["arctic_480b", WIDE])
def prefill_models(request):
    return _build(request.param)


def _serving(rp, model, tcfg):
    """The serving weights on both sides: every float32 leaf of stacked
    rank >= 2 in bf16 (the reference's `_to_serving_dtype`)."""
    rserve = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.dtype == jnp.float32 and a.ndim >= 2 else a, rp)
    serve = tlm.LM(tcfg, torch.Generator(), dtype=torch.bfloat16)
    serve.load_state_dict(model.state_dict())
    return rserve, serve.requires_grad_(False)


def _tokens(cfg, shape=(BATCH, SEQ), seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


@contextlib.contextmanager
def router_gaps(monkeypatch):
    """Record, per token, the port's smallest gap over the layers between
    its k-th and (k+1)-th router probability: the list yields the gaps of
    each forward's tokens in (batch, seq) order, one array per layer."""
    calls = []

    def recorded(p, x, m):
        out = router_probs(p, x, m)
        top = torch.topk(out[1], m.top_k + 1, dim=-1).values
        calls.append((top[..., -2] - top[..., -1]).reshape(-1).numpy())
        return out

    router_probs = tmlp.router_probs
    monkeypatch.setattr(tmlp, "router_probs", recorded)
    yield calls
    monkeypatch.setattr(tmlp, "router_probs", router_probs)


def _decisive(calls, shape):
    """Tokens whose router choice is decisive at every layer of the
    recorded forward(s): the gap is at least NEAR_TIE."""
    return (np.min(np.stack(calls), axis=0) >= NEAR_TIE).reshape(shape)


def test_lm_hidden_and_aux_match_jax(models):
    rcfg, tcfg, rp, model = models
    toks = _tokens(rcfg)
    want, raux = rlm.lm_hidden(rp, jnp.asarray(toks), rcfg)
    got, taux = tlm.lm_hidden(model, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel_l2(got.float().numpy(),
                   np.asarray(want.astype(jnp.float32))) <= 3e-2
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-2)
    # lm_logits of the same hidden state
    hid = np.asarray(want.astype(jnp.float32))
    rl = np.asarray(rlm.lm_logits(rp, jnp.asarray(hid), rcfg))
    tl = tlm.lm_logits(model, torch.from_numpy(hid.copy()), tcfg).numpy()
    np.testing.assert_allclose(tl, rl, rtol=1e-4, atol=1e-5)


def _no_drop(cfg):
    """`cfg` with a capacity factor of E / k: C is the group size, so no
    claim is ever dropped."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def _per_position(got, want):
    return np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)


@pytest.mark.parametrize("capacity", ["config", "no_drop"])
def test_prefill_step_logits_match_jax(prefill_models, capacity,
                                       monkeypatch):
    """Serving weights on both sides.  Where a token's router choice is a
    near tie (gap < NEAR_TIE) a bf16 rounding may flip it, and under the
    config's capacity a flip moves the later claims of its group in
    their queues, so other tokens' drops change too.  With no drop
    (capacity factor E / k) every decisive position is held; with the
    config's capacity, most positions."""
    rcfg, tcfg, rp, model = prefill_models
    if capacity == "no_drop":
        rcfg, tcfg = _no_drop(rcfg), _no_drop(tcfg)
    rserve, serve = _serving(rp, model, tcfg)
    toks = _tokens(rcfg, seed=3)
    hidden, _ = rlm.lm_hidden(rserve, jnp.asarray(toks), rcfg,
                              attn_impl="blockwise")
    want = np.asarray(rlm.lm_logits(rserve, hidden, rcfg).astype(jnp.float32))
    step = make_prefill_step(tcfg, ShapeSpec("t", "prefill", SEQ, BATCH),
                             device="cpu")
    with router_gaps(monkeypatch) as calls:
        got = step.fn(serve, {"inputs": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    rel = _per_position(got, want)
    decisive = _decisive(calls, rel.shape)
    assert decisive.mean() >= 0.85
    if capacity == "no_drop":
        assert rel[decisive].max() <= DECISIVE_RTOL
    else:
        assert (rel <= DECISIVE_RTOL).mean() >= 0.85
    assert np.median(rel) <= 2e-2
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_prefill_of_the_reduced_mla_dims_raises():
    """The reduced deepseek's (nope + rope, v) = (24, 16) has no flash
    attention route: its prefill raises, naming the head dims."""
    _, tcfg, _, model = _build("deepseek_v2_lite_16b")
    step = make_prefill_step(tcfg, ShapeSpec("t", "prefill", 8, 1),
                             device="cpu")
    with pytest.raises(ValueError, match="head dims"):
        step.fn(model.bfloat16(), {"inputs": torch.zeros((1, 8),
                                                         dtype=torch.long)})


def test_lm_loss_matches_jax(models):
    rcfg, tcfg, rp, model = models
    toks = _tokens(rcfg, (BATCH, SEQ + 1), seed=4)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    want, rmet = rlm.lm_loss(rp, jax.tree.map(jnp.asarray, batch), rcfg)
    got, tmet = tlm.lm_loss(model, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)
    np.testing.assert_allclose(float(tmet["aux_loss"]),
                               float(rmet["aux_loss"]), rtol=1e-2)
    assert float(tmet["aux_loss"]) > 0
    api = tmodels.build_model(tcfg, remat=True)
    loss, _ = api.loss(model, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert torch.equal(loss, got)


def test_decode_step_matches_jax(models, monkeypatch):
    """Decode groups a step's B tokens, never past the capacity: only a
    router near tie (gap < NEAR_TIE) can part the two, and such (step,
    row) pairs are counted, not held."""
    rcfg, tcfg, rp, model = models
    rserve, serve = _serving(rp, model, tcfg)
    toks = _tokens(rcfg, (BATCH, STEPS), seed=5)
    step = jax.jit(lambda p, s, t: rlm.decode_step(p, s, t, rcfg))
    rstate = rlm.init_decode_state(rcfg, BATCH, MAX_SEQ)
    serve_step = make_serve_step(tcfg, ShapeSpec("t", "decode", MAX_SEQ,
                                                 BATCH), device="cpu")
    tstate = serve_step.init_state()
    assert set(tstate["caches"]) == set(rstate["caches"])
    for k, c in tstate["caches"].items():
        assert tuple(c.shape) == rstate["caches"][k].shape
    agree, near = 0, 0
    for t in range(STEPS):
        want, rstate = step(rserve, rstate, jnp.asarray(toks[:, t], jnp.int32))
        with router_gaps(monkeypatch) as calls:
            got, tstate = serve_step.fn(serve, tstate,
                                        torch.from_numpy(toks[:, t]))
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        decisive = _decisive(calls, (BATCH,))
        near += int((~decisive).sum())
        rel = _per_position(got.numpy(), want)
        assert (rel[decisive] <= DECISIVE_RTOL).all(), (t, rel)
        agree += int((got.numpy().argmax(-1) == want.argmax(-1)).sum())
    assert near <= 0.15 * BATCH * STEPS
    assert agree >= 0.9 * BATCH * STEPS
    with pytest.raises(ValueError, match="outside the cache"):
        serve_step.fn(serve, tstate, torch.from_numpy(toks[:, 0]))


def test_decode_matches_own_prefill(prefill_models, monkeypatch):
    """Teacher forcing against the port's own prefill (16 tokens a row, one
    group of 32: no drop), positions decisive on both sides held."""
    _, tcfg, rp, model = prefill_models
    _, serve = _serving(rp, model, tcfg)
    toks = torch.from_numpy(_tokens(tcfg, (BATCH, STEPS), seed=6))
    step = make_prefill_step(tcfg, ShapeSpec("t", "prefill", STEPS, BATCH),
                             device="cpu")
    with router_gaps(monkeypatch) as calls:
        want = step.fn(serve, {"inputs": toks}).float().numpy()
    decisive = _decisive(calls, (BATCH, STEPS))
    state = tlm.init_decode_state(tcfg, BATCH, MAX_SEQ, device="cpu")
    agree = 0
    for t in range(STEPS):
        with router_gaps(monkeypatch) as calls:
            got, state = tlm.decode_step(serve, state, toks[:, t], tcfg)
        decisive[:, t] &= _decisive(calls, (BATCH,))
        rel = _per_position(got.numpy(), want[:, t])
        assert (rel[decisive[:, t]] <= DECISIVE_RTOL).all(), (t, rel)
        agree += int((got.numpy().argmax(-1) == want[:, t].argmax(-1)).sum())
    assert decisive.mean() >= 0.8        # decisive on both sides
    assert agree >= 0.9 * BATCH * STEPS


def test_convert_round_trip(models):
    """The port's parameters give back the reference's pytree, leaf for
    leaf and bit for bit (new leaves: MLA's `wq`, `w_dkv`, `w_kr`,
    `kv_norm`, `w_uk`, `w_uv`, `wo`; the MoE's `router`, `wi`, `wg`,
    `wo`, `shared.*`, `dense.*`), and a train state moves both ways."""
    rcfg, tcfg, rp, model = models
    back = convert.lm_params_to_numpy(model)
    want = jax.tree.map(np.asarray, rp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    state = init_state(tcfg, TrainerConfig(), device="cpu")
    tree = convert.train_state_tree(state)
    assert jax.tree.structure(tree["params"]) == jax.tree.structure(want)
    tree = jax.tree.map(lambda t: t.numpy(), tree)
    tree["params"] = want
    fresh = init_state(tcfg, TrainerConfig(), device="cpu")
    convert.load_train_state(tree, fresh)
    for n, p in fresh["params"].named_parameters():
        assert torch.equal(p, model.state_dict()[n]), n


@pytest.mark.parametrize("name", ["deepseek_v2_lite_16b", "arctic_480b"])
def test_count_params_matches_jax(name):
    want = {"deepseek_v2_lite_16b": (16_210_324_992, 2_663_247_360),
            "arctic_480b": (476_850_275_328, 15_584_314_368)}[name]
    full = registry.get(name)
    assert (full.n_params(), full.n_active_params()) == want
    for get in ("get", "reduced"):
        rc, tc = getattr(rregistry, get)(name), getattr(registry, get)(name)
        assert tmodels.count_params(tc) == rmodels.count_params(rc)
        assert tmodels.count_params(tc, active_only=True) == \
            rmodels.count_params(rc, active_only=True)
        assert tmodels.embedding_params(tc) == rmodels.embedding_params(rc)
    assert dataclasses.asdict(registry.get(name)) == dataclasses.asdict(
        rregistry.get(name))
    assert dataclasses.asdict(registry.reduced(name)) == dataclasses.asdict(
        rregistry.reduced(name))


def test_serving_weights_and_ranks(models):
    """Expert tensors (E, D, F) have stacked rank 4: the serving cast, as
    every leaf under `blocks.`, makes them bf16; `final_norm` stays
    float32."""
    _, tcfg, _, _ = models
    serve = tlm.init_lm(tcfg, seed=0, device="cpu", dtype=torch.bfloat16)
    for n, p in serve.named_parameters():
        want = torch.float32 if n == "final_norm.scale" else torch.bfloat16
        assert p.dtype == want, n
    assert tlm.stacked_ndim("blocks.0.ffn.wi", serve.blocks[0].ffn.wi) == 4
    assert tlm.stacked_ndim("blocks.0.ffn.router",
                            serve.blocks[0].ffn.router) == 3


def test_check_dense_admits_moe_and_names_the_item():
    for name in ("deepseek_v2_lite_16b", "arctic_480b"):
        for get in (registry.get, registry.reduced):
            tlm.check_dense(get(name))
            assert tmodels.build_model(get(name)).cfg == get(name)
    cfg = registry.reduced("arctic_480b")
    for family, item in (("vlm", "6.4"), ("hybrid", "6.5"), ("ssm", "6.6"),
                         ("audio", "6.6")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tlm.check_dense(dataclasses.replace(cfg, family=family))
    with pytest.raises(NotImplementedError, match="item 6.7"):
        tlm.check_dense(dataclasses.replace(cfg, pos="learned"))


def test_engine_matches_reference():
    """`ServeEngine` serves the reduced deepseek-v2-lite through
    `build_model`: six requests through four slots, two at temperature
    0.8 fed the reference's draws, the reference's completions."""
    rcfg, tcfg, rp, model = _build("deepseek_v2_lite_16b")
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


def test_synthetic_batches_cover_the_moe_family():
    """`batch_for` gives the MoE family token batches, as the reference's
    does (the port refused every family but the dense one): the dense
    family's batch of the same vocabulary, seed and step."""
    from repro_torch.data.synthetic import batch_for

    moe = registry.reduced("deepseek_v2_lite_16b")
    dense = dataclasses.replace(moe, family="dense", moe=None, mla=None)
    got, want = batch_for(moe, 32, 2, 3), batch_for(dense, 32, 2, 3)
    assert set(got) == {"inputs", "targets"}
    for k in got:
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("name", ["deepseek_v2_lite_16b", "arctic_480b"])
def test_moe_checkpoints_read_both_ways(tmp_path, name):
    """A train state of the MoE family (MLA and expert leaves included)
    written by the reference's `ckpt.save` restores in the port with the
    same bits, and the port's written back restores in the reference."""
    from repro.checkpoint import ckpt as rckpt
    from repro.optim import adamw as radamw
    from repro_torch.checkpoint import ckpt as tckpt

    def leaves(tree):
        return {jax.tree_util.keystr(p): np.asarray(
                    v.float() if isinstance(v, torch.Tensor) else v)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    rcfg, tcfg = rregistry.reduced(name), registry.reduced(name)
    p = rlm.init_lm(jax.random.key(0), rcfg)
    rng = np.random.default_rng(0)
    g = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), p)
    ocfg = radamw.AdamWConfig()
    p, opt, _ = radamw.update(g, radamw.init(p, ocfg), p, ocfg)
    ref = {"params": p, "opt": opt, "step": jnp.int32(7)}
    rckpt.save(tmp_path / "ref", 7, ref)
    state = init_state(tcfg, TrainerConfig(seed=3), device="cpu")
    target = convert.train_state_tree(state, spec=True)
    assert tckpt.tree_fingerprint(target) == rckpt._treedef_fingerprint(ref)
    convert.load_train_state(tckpt.restore(tmp_path / "ref", 7, target),
                             state)
    want = leaves(ref)
    got = leaves(convert.train_state_tree(state))
    assert set(got) == set(want)
    assert "['params']['blocks']['ffn']['wi']" in want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tckpt.save(tmp_path / "port", 8, convert.train_state_tree(state,
                                                             lazy=True))
    back = rckpt.restore(tmp_path / "port", 8, jax.eval_shape(lambda: ref))
    back = leaves(back)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
