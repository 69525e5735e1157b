"""The port's train step over a mesh (`launch.steps.make_train_step(cfg,
mesh)`, `train.trainer`, `launch.train --mesh`) on CPU positions.

Arithmetic: with a float32 backbone and compute cast (`lm.BACKBONE`,
`whisper.BACKBONE`, `steps.COMPUTE_DTYPE` set to float32 on the port
only), a step on a 2x1, 1x2, 2x2 or 4x1 mesh adds the same terms as the
1x1 step in another order: loss, grad norm and updated masters within
rtol 1e-5 / atol 1e-6 of it (measured <= 1.2e-7 relative, 7.5e-9
absolute).  The 1x1 step equals the one-device step bit for bit, and
(bf16 backbone) the reference's one-device step at `test_torch_train`'s
tolerances; its oracle is the reference's `value_and_grad(lm_loss)` +
`adamw.update` unjitted, since the reference's jitted `make_train_step`
raises `ShardingTypeError` on this JAX.  Restart exactness on a mesh is
held bitwise, and checkpoints move between meshes leaf for leaf.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as rckpt
from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.data.synthetic import batch_for
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.train import main as train_main
from repro_torch.models import lm as tlm
from repro_torch.models import whisper as twhisper
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel.sharding import holders
from repro_torch.runtime.fault_tolerance import (RESTART_EXIT_CODE,
                                                 PreemptionGuard)
from repro_torch.train import trainer
from repro_torch.train.trainer import TrainerConfig, train
from torch_port_helpers import leaves, ref_train_step, rel_l2

NAME = "qwen2.5-3b"
SEQ, BATCH = 32, 4
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def f32(monkeypatch):
    for mod in (tlm, twhisper):
        monkeypatch.setattr(mod, "BACKBONE", torch.float32)
    monkeypatch.setattr(tsteps, "COMPUTE_DTYPE", torch.float32)


def _masters(cfg, seed=0) -> dict:
    model = trainer.registry.build_model(cfg).init(seed=seed, device="cpu")
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _mesh_step(cfg, masters, batch, shape, **kw):
    """One step on a ("data", "model") mesh of CPU positions: (metrics,
    {name: gathered master}, state); `kw` go to `make_train_step`."""
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    step = tsteps.make_train_step(cfg, mesh, **kw)
    state = tsteps.shard_params({n: t.clone() for n, t in masters.items()},
                                step.policy, step.opt_cfg)
    state, met = step.fn(state, batch)
    return met, {n: g.cpu() for n, g in state.full()["params"].items()}, state


def _one_device_step(cfg, masters, batch, monkeypatch, **kw):
    """One step on one CPU device: (metrics, {name: master}, {name: the
    grad AdamW was given})."""
    st = trainer.init_state(cfg, TrainerConfig(), device="cpu")
    st["params"].load_state_dict(masters)
    grads = {}
    update = tadamw.update

    def keep(g, *args, **kwargs):
        grads.update({n: t.clone() for n, t in g.items()})
        return update(g, *args, **kwargs)

    with monkeypatch.context() as mp:
        mp.setattr(tadamw, "update", keep)
        st, met = tsteps.make_train_step(cfg, device="cpu", **kw).fn(st,
                                                                     batch)
    return met, {n: p.detach() for n, p in st["params"].named_parameters()}, \
        grads


def _assert_close(a, b):
    (ma, pa), (mb, pb) = a, b
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(ma[k]), float(mb[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for n in pb:
        np.testing.assert_allclose(pa[n].numpy(), pb[n].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def _replicas_equal(state) -> int:
    n = 0
    for name, spec in state.specs.items():
        for owners in holders(state.mesh, spec).values():
            for f in owners[1:]:
                n += 1
                a, b = state.shards[owners[0]], state.shards[f]
                assert torch.equal(a["params"][name], b["params"][name])
                assert torch.equal(a["opt"]["m"][name], b["opt"]["m"][name])
                assert torch.equal(a["opt"]["v"][name], b["opt"]["v"][name])
    return n


@pytest.mark.parametrize("shape,strategy,micro", [
    ((2, 1), "tp", 1), ((1, 2), "fsdp", 1), ((2, 2), "fsdp", 1),
    ((4, 1), "tp", 1), ((2, 1), "tp", 2)],
    ids=["2x1", "1x2-fsdp", "2x2-fsdp", "4x1-tp", "2x1-mb2"])
def test_mesh_step_matches_1x1(f32, shape, strategy, micro):
    cfg = registry.reduced(NAME)
    masters = _masters(cfg)
    batch = batch_for(cfg, SEQ, BATCH, 0, seed=0)
    kw = dict(model_strategy=strategy, microbatches=micro)
    met, params, state = _mesh_step(cfg, masters, batch, shape, **kw)
    ref = _mesh_step(cfg, masters, batch, (1, 1), **kw)
    _assert_close((met, params), ref[:2])
    assert set(met) == set(ref[0])
    np.testing.assert_allclose(float(met["ppl_proxy"]),
                               float(ref[0]["ppl_proxy"]), rtol=RTOL)
    replicas = _replicas_equal(state)
    assert replicas > 0
    assert all(int(s["step"]) == 1 and int(s["opt"]["count"]) == 1
               for s in state.shards)


@pytest.mark.parametrize("strategy,micro", [("tp", 1), ("fsdp", 1),
                                            ("tp", 2)])
def test_1x1_mesh_equals_one_device_step(strategy, micro, monkeypatch):
    """Bit for bit: the gather, the per-leaf grad hook and the shard-wise
    AdamW add nothing on one position (bf16 backbone).  `on_grad` is a
    mesh step's only: one device raises on it."""
    cfg = registry.reduced(NAME)
    masters = _masters(cfg)
    batch = batch_for(cfg, SEQ, BATCH, 0, seed=0)
    kw = dict(model_strategy=strategy, microbatches=micro)
    grads = {}
    met, params, _ = _mesh_step(cfg, masters, batch, (1, 1),
                                on_grad=lambda n, g: grads.update({n: g}),
                                **kw)
    rmet, rparams, rgrads = _one_device_step(cfg, masters, batch,
                                             monkeypatch, **kw)
    with pytest.raises(ValueError, match="on_grad"):
        tsteps.make_train_step(cfg, device="cpu", on_grad=print)
    assert set(met) == set(rmet)
    for k in met:
        assert torch.equal(met[k], rmet[k]), k
    for n in rparams:
        assert torch.equal(params[n], rparams[n]), n
        assert torch.equal(grads[n], rgrads[n]), n


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
def test_1x1_step_matches_reference(strategy):
    """The 1x1 step against the reference's one-device step (ZeRO-3's
    bf16 cast in its loss under "fsdp"), `test_torch_train`'s bounds."""
    rcfg, tcfg = rregistry.reduced("qwen2_5_3b"), registry.reduced(NAME)
    rp = rlm.init_lm(jax.random.key(0), rcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rcfg.vocab, (BATCH, SEQ + 1))
    batch = {"inputs": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}

    def loss_fn(p, b):
        if strategy == "fsdp":
            p = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                             if a.ndim >= 2 and a.dtype == jnp.float32
                             else a, p)
        return rlm.lm_loss(p, b, rcfg)

    ocfg = radamw.AdamWConfig()
    want_p, _, want = ref_train_step(loss_fn, rp, radamw.init(rp, ocfg),
                                     batch, 1, ocfg)
    masters = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp))
    met, params, _ = _mesh_step(
        tcfg, masters, {k: torch.from_numpy(v) for k, v in batch.items()},
        (1, 1), model_strategy=strategy)
    np.testing.assert_allclose(float(met["loss"]), float(want["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(want["grad_norm"]), rtol=2e-2)
    lr = float(want["lr"])
    got, ref = leaves(convert.lm_params_to_numpy(params)), leaves(want_p)
    diff = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert diff.max() <= 2.2 * lr, diff.max() / lr
    assert np.mean(diff <= 0.1 * lr) >= 0.97


@pytest.mark.parametrize("arch,seq", [("zamba2-2.7b", 32),
                                      ("paligemma-3b", 32),
                                      ("whisper-large-v3", 32),
                                      ("xlstm-125m", 32)])
def test_family_2x2_fsdp_matches_1x1(f32, arch, seq):
    """Each family that `PERF_TRAIN_OVERRIDES` trains with ZeRO-3, one
    step on 2x2 against 1x1 (its own microbatches)."""
    cfg = registry.reduced(arch)
    perf = tsteps.PERF_TRAIN_OVERRIDES[registry.get(arch).name]
    masters = _masters(cfg)
    batch = batch_for(cfg, seq, 4 * perf["microbatches"], 0, seed=0)
    got = _mesh_step(cfg, masters, batch, (2, 2), **perf)
    want = _mesh_step(cfg, masters, batch, (1, 1), **perf)
    _assert_close(got[:2], want[:2])


def test_what_the_mesh_step_refuses():
    cfg = registry.reduced(NAME)
    moe = registry.reduced("deepseek-v2-lite-16b")     # groups of 64 tokens
    step = tsteps.make_train_step(moe, make_mesh((2, 1), ("data", "model"),
                                                 device="cpu"))
    state = tsteps.shard_params(_masters(moe), step.policy, step.opt_cfg)
    with pytest.raises(ValueError, match="dispatch groups"):
        step.fn(state, batch_for(moe, 16, 4, 0, seed=0))
    step = tsteps.make_train_step(cfg, make_mesh((2, 1), ("data", "model"),
                                                 device="cpu"))
    state = tsteps.shard_params(_masters(cfg), step.policy, step.opt_cfg)
    with pytest.raises(ValueError, match="rows"):
        step.fn(state, batch_for(cfg, SEQ, 3, 0, seed=0))


def test_int8_moments_on_a_replicated_mesh_match_1x1(f32):
    """int8 moments where no last dimension is split (4x1 "tp": every
    leaf replicated): the same step as on one position."""
    cfg = registry.reduced(NAME)
    masters = _masters(cfg)
    batch = batch_for(cfg, SEQ, BATCH, 0, seed=0)
    quant = tadamw.AdamWConfig(quantized_moments=True)
    got = _mesh_step(cfg, masters, batch, (4, 1), opt_cfg=quant)
    want = _mesh_step(cfg, masters, batch, (1, 1), opt_cfg=quant)
    _assert_close(got[:2], want[:2])


QUANT = tadamw.AdamWConfig(quantized_moments=True)
# leaves of 64-512 columns: the 256 blocks straddle the pieces of 1x4's
# 128 columns (head), and 96 blocks straddle every piece edge here
QUANT_96 = tadamw.AdamWConfig(quantized_moments=True, quant_block=96)
# the int8 moments of a mesh step against 1x1's, the grads' sums in
# another order (measured on these configs: s within 6.2e-6 relative,
# q off by one step on 11 of ~400k entries)
S_RTOL, Q_SHARE = 2e-5, 1e-3
SPLIT_MESHES = {"1x2": ((1, 2), {}), "1x4": ((1, 4), {}),
                "2x2": ((2, 2), {}), "2x2-fsdp": ((2, 2), dict(fsdp=True)),
                "2x2-zero3": ((2, 2), dict(model_strategy="fsdp")),
                "1x4-block96": ((1, 4), dict(opt_cfg=QUANT_96))}


def _gathered(full: dict) -> dict:
    """A `MeshState.full()` tree with its leaves read onto the CPU."""
    return {k: _gathered(v) if isinstance(v, dict) else
            (v.cpu() if hasattr(v, "cpu") else v) for k, v in full.items()}


def _assert_moments_close(got: dict, want: dict, s_rtol: float = S_RTOL,
                          q_share: float = Q_SHARE) -> None:
    """int8 moments {"m", "v"} of two steps: scales within `s_rtol`, q
    within one step on at most `q_share` of the entries."""
    off = total = 0
    for k in ("m", "v"):
        for n, w in want[k].items():
            g = got[k][n]
            assert g["s"].shape == w["s"].shape, n
            np.testing.assert_allclose(g["s"].numpy(), w["s"].numpy(),
                                       rtol=s_rtol, err_msg=n)
            d = (g["q"].int() - w["q"].int()).abs()
            assert int(d.max()) <= 1, n
            off, total = off + int((d > 0).sum()), total + d.numel()
    assert off <= q_share * total, (off, total)


def _assert_quantized_update(cfg, masters, grads, met, full, opt_cfg,
                             opt=None):
    """The mesh's updated masters and int8 moments bit-equal to one
    device's AdamW update of the whole leaves (`masters`, and `opt` or
    zero moments) on the mesh's own grads (`on_grad`) and grad norm: the
    scales of a split leaf are its whole row's, and a piece reads its
    moments back at its columns."""
    params = {n: t.clone() for n, t in tsteps._master_named(
        cfg, masters).items()}
    opt = tadamw.init(params, opt_cfg) if opt is None else {
        "count": opt["count"].clone(),
        **{k: {n: {sub: t.clone() for sub, t in mom.items()}
               for n, mom in opt[k].items()} for k in ("m", "v")}}
    tadamw.update(grads, opt, params, opt_cfg, norm=met["grad_norm"])
    for n in params:
        assert torch.equal(full["params"][n], params[n]), n
        for k in ("m", "v"):
            for sub in ("q", "s"):
                assert torch.equal(full["opt"][k][n][sub],
                                   opt[k][n][sub]), (n, k, sub)


def _quant_replicas_equal(state) -> int:
    n = 0
    for name, spec in state.specs.items():
        for owners in holders(state.mesh, spec).values():
            for f in owners[1:]:
                a, b = state.shards[owners[0]], state.shards[f]
                assert torch.equal(a["params"][name], b["params"][name])
                for k in ("m", "v"):
                    for sub in ("q", "s"):
                        assert torch.equal(a["opt"][k][name][sub],
                                           b["opt"][k][name][sub])
                n += 1
    return n


@pytest.mark.parametrize("mesh", list(SPLIT_MESHES))
def test_int8_moments_split_on_their_last_dim_match_1x1(f32, mesh):
    """int8 moments of leaves split on their last dimension: each
    position quantizes its columns with the whole leaf's block scales
    (block maxima all-reduced over the positions holding the same
    rows).  Masters as `_assert_close` holds them and the moments within
    `S_RTOL` / `Q_SHARE` of 1x1's; bit-equal to one device's update on
    the mesh's own grads."""
    cfg = registry.reduced(NAME)
    masters = _masters(cfg)
    batch = batch_for(cfg, SEQ, BATCH, 0, seed=0)
    shape, kw = SPLIT_MESHES[mesh]
    kw = dict(dict(opt_cfg=QUANT), **kw)
    grads = {}
    met, params, state = _mesh_step(
        cfg, masters, batch, shape,
        on_grad=lambda n, g: grads.update({n: g}), **kw)
    assert tsteps.split_last(state.mesh, state.specs, kw["opt_cfg"])
    ref_kw = {k: v for k, v in kw.items() if k != "fsdp"}
    ref = _mesh_step(cfg, masters, batch, (1, 1), **ref_kw)
    _assert_close((met, params), ref[:2])
    full = _gathered(state.full())
    _assert_moments_close(full["opt"], _gathered(ref[2].full())["opt"])
    _assert_quantized_update(cfg, masters, grads, met, full, kw["opt_cfg"])
    assert _quant_replicas_equal(state) > 0 or mesh.startswith("1x")
    for f in range(state.mesh.size):
        assert state.position_bytes(f) == dryrun.position_bytes(
            cfg, ShapeSpec("t", "train", SEQ, BATCH), state.mesh,
            **{k: v for k, v in kw.items()
               if k != "microbatches"})["state_bytes"]


@pytest.mark.parametrize("mesh", ["1x4", "2x2-fsdp"])
def test_arctic_trains_with_int8_moments_on_a_mesh(f32, mesh):
    """The reduced arctic (a MoE config; named `arctic-reduced`, so
    `default_opt_cfg` gives it float32 moments: its own int8 moments are
    passed here) as the reduced qwen2.5 above, at its dispatch groups'
    64 tokens."""
    cfg = registry.reduced("arctic-480b")
    masters = _masters(cfg)
    batch = batch_for(cfg, 64, BATCH, 0, seed=0)
    shape, kw = SPLIT_MESHES[mesh]
    grads = {}
    met, params, state = _mesh_step(
        cfg, masters, batch, shape, opt_cfg=QUANT,
        on_grad=lambda n, g: grads.update({n: g}), **kw)
    ref = _mesh_step(cfg, masters, batch, (1, 1), opt_cfg=QUANT)
    _assert_close((met, params), ref[:2])
    full = _gathered(state.full())
    _assert_moments_close(full["opt"], _gathered(ref[2].full())["opt"])
    _assert_quantized_update(cfg, masters, grads, met, full, QUANT)


def test_arctic_int8_moments_with_bf16_masters(f32, monkeypatch):
    """arctic-480b's whole optimizer (int8 moments and bf16 masters of
    the leaves of stacked rank >= 2, `PARAM_DTYPE`, keyed by the config's
    name as the reference keys it: set here for the reduced config) on
    1x4 against 1x1: the masters within a bf16 step of 1x1's, each
    dequantized moment within 2^-5 relative L2 of 1x1's (the grads of
    bf16 leaves are bf16; measured 1.4e-2 at most)."""
    cfg = registry.reduced("arctic-480b")
    monkeypatch.setitem(tsteps.PARAM_DTYPE, cfg.name, torch.bfloat16)
    masters = _masters(cfg)
    batch = batch_for(cfg, 64, BATCH, 0, seed=0)
    grads = {}
    met, params, state = _mesh_step(
        cfg, masters, batch, (1, 4), opt_cfg=QUANT,
        on_grad=lambda n, g: grads.update({n: g}))
    ref = _mesh_step(cfg, masters, batch, (1, 1), opt_cfg=QUANT)
    assert params["blocks.0.attn.wq"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(met["loss"]), float(ref[0]["loss"]),
                               rtol=RTOL)
    for n, want in ref[1].items():
        np.testing.assert_allclose(params[n].float().numpy(),
                                   want.float().numpy(), rtol=2 ** -7,
                                   atol=1e-6, err_msg=n)
    full = _gathered(state.full())
    want = _gathered(ref[2].full())["opt"]
    for k in ("m", "v"):
        for n, w in want[k].items():
            got = [tadamw.dequantize_blockwise(m["q"], m["s"], 256)
                   for m in (full["opt"][k][n], w)]
            assert rel_l2(got[0].numpy(), got[1].numpy()) <= 2 ** -5, n
    _assert_quantized_update(cfg, masters, grads, met, full, QUANT)


@pytest.mark.parametrize("shape,block,pieces", [
    ((3, 512), 256, 2), ((3, 512), 256, 4), ((2, 5, 384), 96, 4),
    ((600,), 256, 3), ((4, 64), 256, 4), ((7,), 2, 7)])
def test_quantize_blockwise_on_pieces_equals_the_whole_leaf(shape, block,
                                                            pieces):
    """Columns [i n, (i + 1) n) quantized with their offset and the
    whole leaf's block maxima (the max of the pieces' `block_absmax`) give
    the whole leaf's q columns and its whole scale row, and dequantize
    to its columns; the whole leaf's equal the reference's bit for
    bit."""
    x = torch.from_numpy(np.random.default_rng(sum(shape)).standard_normal(
        shape).astype(np.float32))
    q, s = tadamw.quantize_blockwise(x, block)
    rq, rs = radamw.quantize_blockwise(jnp.asarray(x.numpy()), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    whole = tadamw.dequantize_blockwise(q, s, block)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(
        radamw.dequantize_blockwise(rq, rs, block)))
    n = shape[-1] // pieces
    parts = [x[..., i * n:(i + 1) * n] for i in range(pieces)]
    amax = functools.reduce(torch.maximum, [
        tadamw.block_absmax(p, block, offset=i * n, width=shape[-1])
        for i, p in enumerate(parts)])
    for i, p in enumerate(parts):
        qi, si = tadamw.quantize_blockwise(p, block, offset=i * n,
                                           amax=amax)
        assert torch.equal(qi, q[..., i * n:(i + 1) * n])
        assert torch.equal(si, s)
        assert torch.equal(tadamw.dequantize_blockwise(qi, si, block,
                                                       offset=i * n),
                           whole[..., i * n:(i + 1) * n])
    with pytest.raises(ValueError, match="amax"):
        tadamw.quantize_blockwise(parts[-1], block, offset=shape[-1] - n)


def test_int8_moments_resharded_step_matches_1x1(f32):
    """A second step from one 1x1 state split onto 1x4 (`shard_state`: q
    by the parameters' specs, the scales' whole rows on each position)
    reads the int8 moments back at each piece's columns: bit-equal to
    one device's update of that state on the 1x4 step's grads, its loss
    and grad norm 1x1's.  (Its masters are not held to 1x1's second
    step: where a moment dequantizes to m != 0 and v = 0, the step is m
    over |g|, and a grad that sums near zero in another order moves it
    by several lr.)"""
    cfg = registry.reduced(NAME)
    masters = _masters(cfg)
    batch = batch_for(cfg, SEQ, BATCH, 0, seed=0)
    second = batch_for(cfg, SEQ, BATCH, 1, seed=0)
    _, _, one = _mesh_step(cfg, masters, batch, (1, 1), opt_cfg=QUANT)
    state = _gathered(one.full())
    outs = []
    grads = {}
    for shape in ((1, 1), (1, 4)):
        step = tsteps.make_train_step(
            cfg, make_mesh(shape, ("data", "model"), device="cpu"),
            opt_cfg=QUANT, on_grad=lambda n, g: grads.update({n: g}))
        st, met = step.fn(tsteps.shard_state(state, step.policy), second)
        assert all(int(s["opt"]["count"]) == 2 for s in st.shards)
        outs.append((met, _gathered(st.full())))
    (met, got), (rmet, _) = outs[1], outs[0]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(rmet[k]), rtol=RTOL,
                                   err_msg=k)
    _assert_quantized_update(cfg, state["params"], grads, met, got, QUANT,
                             opt=state["opt"])


def test_mesh_checkpoint_with_int8_moments_loads_in_reference(tmp_path):
    """A 1x4 state with int8 moments written through `MeshState.full()`
    restores in the reference (its one-device layout: q whole, the scale
    rows whole) leaf for leaf, and back onto 1x4 shard for shard."""
    cfg = registry.reduced(NAME)
    _, _, state = _mesh_step(cfg, _masters(cfg),
                             batch_for(cfg, SEQ, BATCH, 0, seed=0), (1, 4),
                             opt_cfg=QUANT)
    ckpt.save(tmp_path, 1, convert.train_state_tree(state.full(), lazy=True))
    rcfg = rregistry.reduced("qwen2_5_3b")
    rquant = radamw.AdamWConfig(quantized_moments=True)
    struct = jax.eval_shape(lambda: {
        "params": rlm.init_lm(jax.random.key(0), rcfg),
        "opt": radamw.init(rlm.init_lm(jax.random.key(0), rcfg), rquant),
        "step": jnp.int32(0)})
    back = leaves(rckpt.restore(tmp_path, 1, struct))
    full = _gathered(state.full())
    want = leaves(jax.tree.map(np.asarray, convert.train_state_tree(full)))
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    again = tsteps.shard_state(full, state.policy)
    for a, b in zip(again.shards, state.shards):
        for k in ("m", "v"):
            for n, mom in b["opt"][k].items():
                for sub in ("q", "s"):
                    assert torch.equal(a["opt"][k][n][sub], mom[sub])


def _tcfg(path, steps, **kw):
    return TrainerConfig(seq=SEQ, global_batch=BATCH, total_steps=steps,
                         ckpt_every=2, ckpt_dir=str(path), log_every=0, **kw)


def test_resume_on_a_mesh_is_bitwise_identical(tmp_path):
    cfg = registry.reduced(NAME)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    kw = dict(model_strategy="fsdp")
    ref = train(cfg, _tcfg(tmp_path / "ref", 5, **kw), mesh=mesh)
    guard = PreemptionGuard()

    def on_step(step, metrics):
        if step == 1:
            guard.request()

    r1 = train(cfg, _tcfg(tmp_path / "int", 5, **kw), guard=guard,
               on_step=on_step, mesh=mesh)
    r2 = train(cfg, _tcfg(tmp_path / "int", 5, **kw), mesh=mesh)
    assert r1.exit_code == RESTART_EXIT_CODE and r1.steps_run == 2
    assert r2.exit_code == 0 and r2.steps_run == 3
    np.testing.assert_array_equal(np.asarray(r1.losses + r2.losses),
                                  np.asarray(ref.losses))
    assert all(np.isfinite(ref.losses))


def _ckpt_leaves(path, step) -> dict:
    empty = trainer._empty_state(registry.reduced(NAME), TrainerConfig(),
                                 torch.device("cpu"))
    tree = ckpt.restore(path, step, convert.train_state_tree(empty,
                                                             spec=True))
    return leaves(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_train_cli_on_a_mesh_restarts_bitwise(tmp_path, mesh):
    """`launch.train --mesh 2x1 --device cpu --reduced` (and 1x2: tensor
    parallelism, "tp" over a "model" axis of 2): 2 steps then 2 more
    from the checkpoint end on the state of 4 straight steps, leaf for
    leaf."""
    args = ["--arch", NAME, "--reduced", "--mesh", mesh, "--device", "cpu",
            "--seq", str(SEQ), "--batch", str(BATCH), "--ckpt-every", "2"]
    assert train_main(args + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "a")]) == 0
    assert train_main(args + ["--steps", "2", "--ckpt-dir",
                              str(tmp_path / "b")]) == 0
    assert train_main(args + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "b")]) == 0
    a, b = _ckpt_leaves(tmp_path / "a", 4), _ckpt_leaves(tmp_path / "b", 4)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["['step']"]) == 4


def test_checkpoint_moves_between_meshes(tmp_path):
    """A checkpoint written on 2x1 loads on one device, on 1x1 and on 2x2
    ("fsdp"), each gathering back to the checkpoint's leaves exactly."""
    cfg = registry.reduced(NAME)
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    assert train(cfg, _tcfg(tmp_path, 2), mesh=mesh).exit_code == 0
    want = _ckpt_leaves(tmp_path, 2)
    one = trainer._empty_state(cfg, TrainerConfig(), torch.device("cpu"))
    tree = ckpt.restore(tmp_path, 2, convert.train_state_tree(one, spec=True))
    convert.load_train_state(tree, one)
    states = [one]
    for shape, strategy in (((1, 1), "tp"), ((2, 2), "fsdp")):
        pol = tsteps.make_train_step(
            cfg, make_mesh(shape, ("data", "model"), device="cpu"),
            model_strategy=strategy).policy
        states.append(tsteps.shard_state(one, pol).full())
    for st in states:
        got = leaves(jax.tree.map(np.asarray, convert.train_state_tree(st)))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mesh_entry_points_without_cuda_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((2, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", NAME, "--reduced", "--mesh", "2x1",
                    "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("arch", sorted(tsteps.PERF_TRAIN_OVERRIDES))
def test_train_cli_perf_applies_every_override(arch, tmp_path, monkeypatch):
    """`--perf` puts every key of the arch's override into the trainer's
    config (arctic's `cast_bf16` too), and the trainer hands the cast to
    its step."""
    import repro_torch.launch.train as tlaunch
    seen = {}
    monkeypatch.setattr(tlaunch, "train", lambda cfg, tcfg, **kw: seen.update(
        tcfg=tcfg) or trainer.TrainResult(0, [], 0, []))
    assert train_main(["--arch", arch, "--reduced", "--perf", "--device",
                       "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    for k, v in tsteps.PERF_TRAIN_OVERRIDES[arch].items():
        assert getattr(seen["tcfg"], k) == v, k
    step_kw = {}

    def make_train_step(cfg, mesh, **kw):
        step_kw.update(kw)
        raise StopIteration

    monkeypatch.setattr(trainer.steps_mod, "make_train_step",
                        make_train_step)
    with pytest.raises(StopIteration):
        train(registry.reduced(NAME), seen["tcfg"], device="cpu")
    assert step_kw["cast_bf16"] == seen["tcfg"].cast_bf16
    assert step_kw["model_strategy"] == seen["tcfg"].model_strategy
