"""The port's blockwise prefill path (qwen2.5 / qwen3 configs, dense
family) held against the JAX reference on the CPU, on the configs'
`REDUCED` variants (2 layers, d 64, 4 heads / 2 KV heads, head dim 16,
vocab 512) at S 96, batch 2.

Parameters come from the reference's `init_lm` and are carried over by
`convert.lm_params_from_numpy` (with non-zero QKV biases where the
config has them); tokens and activations are drawn with numpy.  The
reference runs its jnp blockwise core; the port runs `flash_attention`'s
plain path, which computes the products in float32 where the core
rounds them to the activations' dtype.

Tolerances:
- `attention_fwd_blockwise` in float32: atol = rtol = 1e-5 (measured
  <= 1e-6).
- `attention_fwd_blockwise` in bfloat16: the reference rounds scores and
  P.V to bf16, the port does not; rel L2 <= 1e-2 (measured <= 4.4e-3),
  max abs <= 0.05 (measured <= 0.016, one bf16 ulp at |out| 2-4).
- `lm_hidden` (dense and blockwise) and the prefill logits: the
  reference's backbone is bf16 whatever the parameters' dtype, and XLA
  and torch round bf16 products apart here and there, over 2 layers:
  rel L2 <= 3e-2 (measured <= 1.2e-2); the prefill's argmax over the
  vocabulary agrees at >= 90 % of positions (measured 97.9-100 %).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.launch import shapes as rshapes
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

NAMES = ("qwen2_5_3b", "qwen3_8b")
SEQ, BATCH = 96, 2


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module", params=NAMES)
def models(request):
    """(reference cfg, port cfg, reference params, port LM) of one
    config's REDUCED variant."""
    rcfg, tcfg = rregistry.reduced(request.param), registry.reduced(
        request.param)
    rp = rlm.init_lm(jax.random.key(0), rcfg)
    if rcfg.attn_bias:
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


def _tokens(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, SEQ))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prefix_len", [0, 20])
def test_attention_fwd_blockwise_matches_jax(models, dtype, prefix_len):
    rcfg, tcfg, rp, model = models
    x = np.random.default_rng(1).standard_normal(
        (BATCH, SEQ, rcfg.d_model)).astype(np.float32)
    rlayer = jax.tree.map(lambda a: a[0], rp["blocks"])["attn"]
    want = rattn.attention_fwd_blockwise(
        rlayer, jnp.asarray(x).astype(getattr(jnp, dtype)), rcfg,
        positions=jnp.arange(SEQ), kv_block=32, prefix_len=prefix_len)
    with torch.no_grad():
        got = tattn.attention_fwd_blockwise(
            model.blocks[0].attn, torch.from_numpy(x).to(getattr(torch, dtype)),
            tcfg, positions=torch.arange(SEQ), kv_block=32,
            prefix_len=prefix_len)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert _rel_l2(got, want) <= 1e-2
        assert np.abs(got - want).max() <= 0.05


@pytest.mark.parametrize("attn_impl", ["dense", "blockwise"])
def test_lm_hidden_matches_jax(models, attn_impl):
    rcfg, tcfg, rp, model = models
    toks = _tokens(rcfg)
    want, _ = rlm.lm_hidden(rp, jnp.asarray(toks), rcfg, attn_impl=attn_impl)
    with torch.no_grad():
        got, aux = tlm.lm_hidden(model, torch.from_numpy(toks), tcfg,
                                 attn_impl=attn_impl)
    assert float(aux) == 0.0                 # the dense family has no router
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel_l2(got.float().numpy(),
                   np.asarray(want.astype(jnp.float32))) <= 3e-2


def test_prefill_step_logits_match_jax(models):
    """Serving weights (float32 matrices cast to bf16, the reference's
    `_to_serving_dtype`) on both sides."""
    rcfg, tcfg, rp, model = models
    rserve = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.dtype == jnp.float32 and a.ndim >= 2 else a, rp)
    toks = _tokens(rcfg)
    hidden, _ = rlm.lm_hidden(rserve, jnp.asarray(toks), rcfg,
                              attn_impl="blockwise")
    want = np.asarray(rlm.lm_logits(rserve, hidden, rcfg).astype(jnp.float32))
    serve = tlm.LM(tcfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    serve.load_state_dict(model.state_dict())
    step = make_prefill_step(tcfg, ShapeSpec("t", "prefill", SEQ, BATCH),
                             device="cpu")
    assert step.batch_shapes == {"inputs": (BATCH, SEQ)}
    got = step.fn(serve, {"inputs": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and got.shape == (BATCH, SEQ,
                                                         rcfg.vocab)
    got = got.float().numpy()
    assert _rel_l2(got, want) <= 3e-2
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("name", NAMES)
def test_configs_and_shapes_equal_reference(name):
    assert dataclasses.asdict(registry.get(name)) == dataclasses.asdict(
        rregistry.get(name))
    assert dataclasses.asdict(registry.reduced(name.replace("_", "-"))) == \
        dataclasses.asdict(rregistry.reduced(name))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rshapes.SHAPES.items()}


def test_registry_raises_for_configs_not_ported():
    assert registry.canonical("qwen2.5-3b") == "qwen2_5_3b"
    for name in set(rregistry.ARCH_IDS) - set(registry.PORTED):
        with pytest.raises(NotImplementedError, match=name):
            registry.get(name)
    with pytest.raises(KeyError):
        registry.get("gpt-5")


def test_serving_init_casts_matrices_only():
    """The serving cast follows the reference's `_to_serving_dtype` on its
    stacked tree: every float32 leaf of stacked rank >= 2 goes to bf16.
    A layer's norm scales and QKV biases are (L, d) there, so they are
    cast with the matrices; only `final_norm.scale` stays float32."""
    cfg = registry.reduced("qwen2.5-3b")
    f32 = tlm.init_lm(cfg, seed=3, device="cpu")
    bf16 = tlm.init_lm(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    for (name, a), (_, b) in zip(f32.named_parameters(),
                                 bf16.named_parameters()):
        if tlm.stacked_ndim(name, a) >= 2:
            assert b.dtype == torch.bfloat16, name
            assert torch.equal(a.to(torch.bfloat16), b), name
        else:
            assert b.dtype == torch.float32 and torch.equal(a, b), name
    assert bf16.blocks[0].ln1.scale.dtype == torch.bfloat16
    assert bf16.blocks[1].attn.bq.dtype == torch.bfloat16
    assert bf16.final_norm.scale.dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_serving_dtypes_match_reference(name):
    """Leaf by leaf, the port's bf16 serving tree (stacked back by
    `convert.train_state_tree`) has the dtype the reference's
    `_to_serving_dtype` gives its `init_lm` tree."""
    from repro.launch import steps as rsteps

    rcfg, tcfg = rregistry.reduced(name), registry.reduced(name)
    want = rsteps._to_serving_dtype(jax.eval_shape(
        lambda: rlm.init_lm(jax.random.key(0), rcfg)))
    serve = tlm.init_lm(tcfg, seed=0, device="cpu", dtype=torch.bfloat16)
    got = convert.train_state_tree({"params": serve}, spec=True)["params"]
    want = {jax.tree_util.keystr(p): str(v.dtype) for p, v
            in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {jax.tree_util.keystr(p): str(v.dtype).split(".")[-1] for p, v
           in jax.tree_util.tree_flatten_with_path(
               got, is_leaf=lambda x: hasattr(x, "dtype"))[0]}
    assert got == want
    assert want["['final_norm']['scale']"] == "float32"
    assert want["['blocks']['ln1']['scale']"] == "bfloat16"


def test_prefill_with_trained_norms_and_biases_matches_jax():
    """Norm scales and QKV biases that are not bf16-exact (as trained
    weights are): the serving tree of each side casts them to bf16, so
    each layer's norm agrees on the same input to rtol 1e-6 (measured
    3.2e-7: the mean's summation order; a float32 scale would differ by
    up to 2^-9 of the output), and the prefill logits stay within this
    file's bounds (rel L2 <= 3e-2, argmax >= 90 %; measured 9.9e-3
    and 99.0 %)."""
    rcfg, tcfg = rregistry.reduced("qwen2_5_3b"), registry.reduced(
        "qwen2.5-3b")
    rng = np.random.default_rng(11)
    rp = rlm.init_lm(jax.random.key(2), rcfg)
    rp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.1 * rng.standard_normal(
            a.shape).astype(np.float32))
        if jax.tree_util.keystr(path).endswith(("['scale']", "['bq']",
                                                "['bk']", "['bv']"))
        else a, rp)
    rserve = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.dtype == jnp.float32 and a.ndim >= 2 else a, rp)
    serve = tlm.LM(tcfg, torch.Generator().manual_seed(0),
                   dtype=torch.bfloat16)
    serve.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    x = rng.standard_normal((BATCH, SEQ, rcfg.d_model)).astype(np.float32)
    from repro.models import common as rcommon
    from repro_torch.models import common as tcommon
    for i in range(rcfg.n_layers):
        rln = jax.tree.map(lambda a: a[i], rserve["blocks"]["ln1"])
        want = np.asarray(rcommon.rmsnorm(rln, jnp.asarray(x)))
        got = tcommon.rmsnorm(serve.blocks[i].ln1.scale.detach(),
                              torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    toks = _tokens(rcfg)
    hidden, _ = rlm.lm_hidden(rserve, jnp.asarray(toks), rcfg,
                              attn_impl="blockwise")
    want = np.asarray(rlm.lm_logits(rserve, hidden, rcfg).astype(jnp.float32))
    step = make_prefill_step(tcfg, ShapeSpec("t", "prefill", SEQ, BATCH),
                             device="cpu")
    got = step.fn(serve, {"inputs": torch.from_numpy(toks)}).float().numpy()
    assert _rel_l2(got, want) <= 3e-2, _rel_l2(got, want)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_lm_hidden_refuses_what_is_not_ported(models):
    rcfg, tcfg, rp, model = models
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="prefix_embeds"):  # not (B, P, D)
        tlm.lm_hidden(model, toks, tcfg, prefix_embeds=torch.zeros(
            (1, 2, tcfg.d_model + 1)))
    with pytest.raises(ValueError, match="xlstm sub-config"):
        tlm.lm_hidden(model, toks, dataclasses.replace(tcfg, family="ssm"))
    with pytest.raises(ValueError, match="models.whisper"):
        tlm.lm_hidden(model, toks, dataclasses.replace(tcfg, family="audio"))
    with pytest.raises(ValueError, match="attn_impl"):
        tlm.lm_hidden(model, toks, tcfg, attn_impl="paged")
    with pytest.raises(ValueError, match="ssm and hybrid sub-configs"):
        make_prefill_step(dataclasses.replace(tcfg, family="hybrid"),
                          SHAPES["prefill_32k"], device="cpu")


@pytest.mark.parametrize("prefix_len", [0, 20])
def test_tensor_core_route_matches_jax(prefix_len):
    """The reduced qwen2.5 widened to head dim 128 takes the tensor-core
    route (`flash_attention_tc_ref` on the CPU: float32 scores, P in
    bf16) in bfloat16: `attention_fwd_blockwise` and the 2-layer prefill
    logits against the reference's jnp core (tolerances measured as
    below)."""
    rcfg = dataclasses.replace(rregistry.reduced("qwen2_5_3b"), head_dim=128)
    tcfg = dataclasses.replace(registry.reduced("qwen2.5-3b"), head_dim=128)
    assert tkernel.route(torch.bfloat16, tcfg.resolved_head_dim) == "wgmma"
    rp = rlm.init_lm(jax.random.key(1), rcfg)
    serve = tlm.LM(tcfg, torch.Generator().manual_seed(0),
                   dtype=torch.bfloat16)
    rserve = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                          if a.dtype == jnp.float32 and a.ndim >= 2 else a, rp)
    serve.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rp)), strict=True)
    x = np.random.default_rng(4).standard_normal(
        (BATCH, SEQ, rcfg.d_model)).astype(np.float32)
    rlayer = jax.tree.map(lambda a: a[0], rserve["blocks"])["attn"]
    want = np.asarray(rattn.attention_fwd_blockwise(
        rlayer, jnp.asarray(x).astype(jnp.bfloat16), rcfg,
        positions=jnp.arange(SEQ), kv_block=32,
        prefix_len=prefix_len).astype(jnp.float32))
    with torch.no_grad():
        got = tattn.attention_fwd_blockwise(
            serve.blocks[0].attn, torch.from_numpy(x).bfloat16(), tcfg,
            positions=torch.arange(SEQ), kv_block=32,
            prefix_len=prefix_len).float().numpy()
    assert _rel_l2(got, want) <= 1e-2          # measured <= 4.0e-3
    assert np.abs(got - want).max() <= 0.05    # measured <= 0.016
    if prefix_len:
        return
    toks = _tokens(rcfg)
    hidden, _ = rlm.lm_hidden(rserve, jnp.asarray(toks), rcfg,
                              attn_impl="blockwise")
    want = np.asarray(rlm.lm_logits(rserve, hidden, rcfg).astype(jnp.float32))
    step = make_prefill_step(tcfg, ShapeSpec("t", "prefill", SEQ, BATCH),
                             device="cpu")
    got = step.fn(serve, {"inputs": torch.from_numpy(toks)}).float().numpy()
    assert _rel_l2(got, want) <= 3e-2          # measured 1.08e-2
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9   # 0.979
