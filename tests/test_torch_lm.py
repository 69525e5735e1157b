"""The port's LM substrate and CIM-in-the-loop trainer held against the
JAX reference on the CPU, at a small size (d 64, 2 layers, vocab 256,
seq 16, batch 2).

The JAX side's step is the reference example's (`examples/
train_acim_lm.py`) loss and SGD update, written here with `repro`
modules; its `init_lm` parameters are carried into the port by
`convert.lm_params_from_numpy`, and its mismatch draws
(`normal(key(instance_seed), w.shape)`) are handed over by shape.

Tolerances:
- float32 building blocks (norms, RoPE, attention, MLP, loss): rtol
  1e-5 (transcendentals and reduction order differ by ulps).
- The training steps (`STEP_CASES`) run the CIM path, which is
  discontinuous: sign binarization, the STE window |x/s_x| <= 1 and the
  ADC decisions turn a rounding difference into a whole flip.  With a
  float32 backbone the digital path agrees to float32 rounding (losses
  rtol 1e-5, each tensor's 3-step update to 1e-3 in L2); the CIM path's
  losses to 1e-4 and its updates to 5 % in L2 (a few STE-window flips
  move the small `ln2.scale` updates most; measured <= 3.5 %).  With the
  example's bfloat16 backbone XLA and torch round bf16 matmuls one ulp
  (2^-8) apart here and there, and those roundings flip binarized
  activations near zero: step-0 losses agree to 1e-3 (measured 3e-4),
  later losses to 1e-2 (measured 3e-3) and updates to 25 % in L2
  (measured <= 19 %, in the last layer's FFN).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RArchConfig
from repro.core.acim_spec import MacroSpec as RSpec
from repro.models import attention as rattn
from repro.models import common as rcommon
from repro.models import lm as rlm
from repro.models import mlp as rmlp
from repro.quant.cim_linear import CIMConfig as RCIMConfig
from repro.quant.cim_linear import cim_linear as rcim_linear
from repro_torch import convert
from repro_torch.configs.base import ArchConfig
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.data import synthetic
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.quant.cim_linear import CIMConfig
from repro_torch.train import acim_lm
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

D, LAYERS, VOCAB, SEQ, BATCH, LR = 64, 2, 256, 16, 2, 3e-3


def _cfgs(**kw):
    base = dict(name="acim-lm", family="dense", n_layers=LAYERS, d_model=D,
                n_heads=2, n_kv_heads=2, d_ff=4 * D, vocab=VOCAB,
                norm="rmsnorm", act="silu", mlp_gated=False)
    base.update(kw)
    return RArchConfig(**base), ArchConfig(**base)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port_model(rparams, cfg):
    model = tlm.LM(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, rparams)), strict=True)
    return model


# ---------------------------------------------------------------------------
# building blocks (float32)
# ---------------------------------------------------------------------------
def test_params_carry_over_and_init_keeps_shapes():
    rcfg, tcfg = _cfgs()
    rparams = rlm.init_lm(jax.random.key(0), rcfg)
    model = _port_model(rparams, tcfg)
    np.testing.assert_array_equal(model.blocks[1].attn.wq.detach().numpy(),
                                  np.asarray(rparams["blocks"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(model.head.detach().numpy(),
                                  np.asarray(rparams["head"]))
    fresh = tlm.init_lm(tcfg, seed=0, device="cpu")
    assert {k: v.shape for k, v in fresh.state_dict().items()} == \
        {k: v.shape for k, v in model.state_dict().items()}
    # the reference's distributions: truncated normal / sqrt(fan_in)
    wi = fresh.blocks[0].ffn.wi.detach()
    assert float(wi.abs().max()) <= 2.0 / np.sqrt(D) + 1e-7
    np.testing.assert_allclose(float(wi.std()), 0.88 / np.sqrt(D), rtol=0.05)
    assert torch.equal(tlm.init_lm(tcfg, seed=0, device="cpu").emb, fresh.emb)


@pytest.mark.parametrize("qk_norm,attn_bias,kv", [(False, False, 2),
                                                  (True, True, 1)])
def test_attention_norm_rope_match(qk_norm, attn_bias, kv):
    rcfg, tcfg = _cfgs(n_heads=4, n_kv_heads=kv, qk_norm=qk_norm,
                       attn_bias=attn_bias)
    rp = rattn.init_attention(jax.random.key(1), rcfg)
    if attn_bias:
        rp = {**rp, "bq": jnp.full_like(rp["bq"], 0.1),
              "bk": jnp.full_like(rp["bk"], -0.2)}
    tp = tattn.init_attention(tcfg, torch.Generator().manual_seed(0))
    tp.load_state_dict(convert.lm_params_from_numpy(
        {"blocks": {}, **jax.tree.map(np.asarray, rp)}), strict=True)
    x = np.random.default_rng(0).standard_normal((BATCH, SEQ, D)
                                                 ).astype(np.float32)
    pos = np.arange(SEQ)
    want = rattn.attention_fwd(rp, jnp.asarray(x), rcfg,
                               mask=rcommon.causal_mask(SEQ),
                               positions=jnp.asarray(pos))
    got = tattn.attention_fwd(tp, _t(x), tcfg, mask=tcommon.causal_mask(SEQ),
                              positions=_t(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    scale = np.linspace(0.5, 1.5, D).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rmsnorm(_t(scale), _t(x)).numpy(),
        np.asarray(rcommon.rmsnorm({"scale": scale}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tcommon.layernorm(_t(scale), _t(scale - 1), _t(x)).numpy(),
        np.asarray(rcommon.layernorm({"scale": scale, "bias": scale - 1},
                                     jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gated,bias,act", [(False, False, "silu"),
                                            (True, True, "gelu")])
def test_mlp_and_loss_match(gated, bias, act):
    rcfg, tcfg = _cfgs(mlp_gated=gated, mlp_bias=bias, act=act)
    rp = rmlp.init_mlp(jax.random.key(2), D, 4 * D, rcfg)
    tp = tmlp.init_mlp(D, 4 * D, tcfg, torch.Generator().manual_seed(0))
    tp.load_state_dict({k: _t(v) for k, v in rp.items()}, strict=True)
    x = np.random.default_rng(1).standard_normal((BATCH, SEQ, D)
                                                 ).astype(np.float32)
    np.testing.assert_allclose(
        tmlp.mlp_fwd(tp, _t(x), tcfg).detach().numpy(),
        np.asarray(rmlp.mlp_fwd(rp, jnp.asarray(x), rcfg)),
        rtol=1e-5, atol=1e-5)
    logits = 3 * np.random.default_rng(2).standard_normal(
        (BATCH, SEQ, VOCAB)).astype(np.float32)
    labels = np.random.default_rng(3).integers(0, VOCAB, (BATCH, SEQ))
    lr_, mr = rcommon.softmax_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels))
    lt, mt = tcommon.softmax_cross_entropy(_t(logits), _t(labels))
    np.testing.assert_allclose(float(lt), float(lr_), rtol=1e-5)
    for k in mr:
        np.testing.assert_allclose(float(mt[k]), float(mr[k]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole: 3 SGD steps of the CIM-native LM
# ---------------------------------------------------------------------------
def _jax_step(cfg, cim, lr, backbone=jnp.bfloat16):
    """The reference example's `loss_fn` and `step`, verbatim but for the
    config closure and the backbone dtype."""
    def loss_fn(params, batch):
        x = params["emb"][batch["inputs"]].astype(backbone)
        mask = rcommon.causal_mask(x.shape[1])
        pos = jnp.arange(x.shape[1])

        def block(x, lp):
            h = rcommon.apply_norm(lp["ln1"], x, cfg.norm)
            x = x + rattn.attention_fwd(lp["attn"], h, cfg, mask=mask,
                                        positions=pos)
            h = rcommon.apply_norm(lp["ln2"], x, cfg.norm).astype(jnp.float32)
            ff = jax.nn.silu(rcim_linear(h, lp["ffn"]["wi"], cim))
            x = x + rcim_linear(ff, lp["ffn"]["wo"], cim).astype(x.dtype)
            return x, None

        x, _ = jax.lax.scan(block, x, params["blocks"])
        x = rcommon.apply_norm(params["final_norm"], x, cfg.norm)
        logits = rlm.lm_logits(params, x, cfg)
        return rcommon.softmax_cross_entropy(logits, batch["targets"])[0]

    @jax.jit
    def step(params, batch):
        loss, g = jax.value_and_grad(loss_fn)(params, batch)
        params = jax.tree.map(lambda p, gg: p - lr * gg.astype(p.dtype),
                              params, g)
        return params, loss

    return step


# (mode, backbone, loss rtol at step 0 / later, max relative L2 error of
# each tensor's 3-step update); see the module docstring.
STEP_CASES = {
    "digital-f32": ("digital", "float32", 1e-6, 1e-5, 1e-3),
    "cim-f32": ("cim", "float32", 1e-6, 1e-4, 5e-2),
    "cim_mismatch-f32": ("cim_mismatch", "float32", 1e-6, 1e-4, 5e-2),
    "cim_mismatch-bf16": ("cim_mismatch", "bfloat16", 1e-3, 1e-2, 0.25),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_sgd_steps_match_jax(case, monkeypatch):
    mode, backbone, rtol0, rtol, upd_tol = STEP_CASES[case]
    monkeypatch.setattr(acim_lm, "BACKBONE_DTYPE", getattr(torch, backbone))
    rcfg, tcfg = _cfgs()
    spec = (64, 256, 2, 4)                    # N = 32, B = 4: 2 and 8 chunks
    rcim = tcim = None
    if mode != "digital":
        mm = mode == "cim_mismatch"
        rcim = RCIMConfig(RSpec(*spec), mismatch=mm, instance_seed=5)
        tcim = CIMConfig(MacroSpec(*spec), mismatch=mm, instance_seed=5)
    eps = {shape: _t(jax.random.normal(jax.random.key(5), shape, jnp.float32))
           for shape in [(D, 4 * D), (4 * D, D)]}
    rparams = rlm.init_lm(jax.random.key(0), rcfg)
    p0 = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rparams))
    model = _port_model(rparams, tcfg)
    step = _jax_step(rcfg, rcim, LR, getattr(jnp, backbone))
    for i in range(3):
        toks = np.random.default_rng(i).integers(0, VOCAB, (BATCH, SEQ + 1))
        rb = {"inputs": jnp.asarray(toks[:, :-1], jnp.int32),
              "targets": jnp.asarray(toks[:, 1:], jnp.int32)}
        tb = {"inputs": _t(toks[:, :-1]), "targets": _t(toks[:, 1:])}
        rparams, rloss = step(rparams, rb)
        tloss = acim_lm.sgd_step(model, tb, tcfg, tcim, LR, eps=eps)
        np.testing.assert_allclose(float(tloss), float(rloss),
                                   rtol=rtol0 if i == 0 else rtol)
    got = model.state_dict()
    for k, want in convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, rparams)).items():
        upd_r, upd_t = want - p0[k], got[k] - p0[k]
        err = float(torch.linalg.norm(upd_t - upd_r) / torch.linalg.norm(upd_r))
        assert err <= upd_tol, (k, err)


# ---------------------------------------------------------------------------
# data and the trainer's entry points
# ---------------------------------------------------------------------------
def test_batch_for_is_deterministic_zipf_with_copy_structure():
    _, tcfg = _cfgs()
    a = synthetic.batch_for(tcfg, 128, 8, step=3)
    b = synthetic.batch_for(tcfg, 128, 8, step=3)
    c = synthetic.batch_for(tcfg, 128, 8, step=4)
    assert torch.equal(a["inputs"], b["inputs"])
    assert not torch.equal(a["inputs"], c["inputs"])
    assert a["inputs"].shape == a["targets"].shape == (8, 128)
    assert torch.equal(a["inputs"][:, 1:], a["targets"][:, :-1])
    toks = torch.cat([a["inputs"], a["targets"][:, -1:]], 1)
    assert 0 <= int(toks.min()) and int(toks.max()) < VOCAB
    # unigram: rank-1 token has p = 1/H(256, 1.2) ~ 0.23 (copies keep it)
    p1 = synthetic._zipf_probs(synthetic.DataConfig(VOCAB, 128, 8))[0]
    np.testing.assert_allclose(float((toks == 0).float().mean()), p1,
                               atol=0.03)
    # copy structure: token[t] == token[t - 64] for ~1/4 of the positions
    # (a copy of a token that was not itself copied) plus Zipf collisions
    same = float((toks[:, 64:] == toks[:, :-64]).float().mean())
    assert 0.25 < same < 0.5, same
    with pytest.raises(ValueError, match="unknown family"):
        synthetic.batch_for(_cfgs(family="encoder")[1], 8, 2, 0)


def test_trainer_runs_on_cpu_and_learns():
    cfg = acim_lm.build_cfg(64, 1)
    model = tlm.init_lm(cfg, seed=0, device="cpu")
    cim = CIMConfig(MacroSpec(256, 64, 2, 4))
    log = acim_lm.train(model, cfg, cim, steps=6, seq=32, batch=4, lr=0.05)
    assert len(log.losses) == len(log.step_s) == 6
    assert all(np.isfinite(log.losses)) and log.losses[-1] < log.losses[0]


def test_trainer_main_on_cpu(capsys):
    acim_lm.main(["--device", "cpu", "--d-model", "64", "--layers", "1",
                  "--steps", "2", "--seq", "16", "--batch", "2"])
    out = capsys.readouterr().out
    assert "codesign pick" in out and "step    1 loss" in out


def test_trainer_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        acim_lm.main(["--steps", "1", "--no-cim"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_lm(acim_lm.build_cfg(64, 1))
