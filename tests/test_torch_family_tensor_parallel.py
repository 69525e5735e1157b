"""Local tensor parallelism over "model" for the hybrid, SSM and audio
families (`parallel.tensor_parallel`'s Mamba2 mixer, zamba2's shared
block, the mLSTM with its sLSTM on the group's first position, whisper's
encoder, self- and cross-attention) in the port's mesh train step, on
CPU positions.

Arithmetic: with the `f32` fixture (float32 backbone and compute cast), a
step on 1x2, 1x4, 2x2 (with and without FSDP, one or two microbatches)
adds the same terms as the 1x1 step in another order: loss, grad norm
and every updated master within rtol 1e-5 / atol 1e-6 of it, replicated
pieces bit-equal on their positions.  The reduced configs: zamba2 with 8
SSM heads and 4 attention heads, xlstm with 2 heads (at 1x4 they do not
divide, so the mLSTM runs whole on every position; one case widens it
to 4 heads at 1x2, two a position), whisper with 4 heads and a
vocabulary of 512.  With the bf16 backbone the 1x2 step is held to
the reference's one-device step (`torch_port_helpers.ref_train_step`,
unjitted) at `test_tp_1x2_matches_reference`'s bounds.  Each new
sublayer's local form is held to the whole sublayer, the packed cuts to
their heads' columns, the bytes each position holds to the dry-run's,
and the dry-run's count of what the step sends to the calls it makes.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.models import whisper as rwhisper
from repro.optim import adamw as radamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data.synthetic import batch_for
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import whisper as twhisper
from repro_torch.models import xlstm as txlstm
from repro_torch.models.common import causal_mask
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import (cut_overlaps, kept_spec,
                                           make_policy, model_cut,
                                           model_local, region, shard_count)
from test_torch_sharded_train import (  # noqa: F401  (f32: a fixture)
    ATOL, RTOL, _assert_close, _masters, _mesh_step, _replicas_equal, f32)
from torch_port_helpers import leaves, ref_train_step

SEQ, BATCH = 32, 4
ARCHS = ("zamba2-2.7b", "xlstm-125m", "whisper-large-v3")
MESHES = {"1x2": ((1, 2), {}), "1x4": ((1, 4), {}), "2x2": ((2, 2), {}),
          "2x2-fsdp": ((2, 2), dict(fsdp=True)),
          "2x2-mb2": ((2, 2), dict(microbatches=2))}


@functools.lru_cache(maxsize=None)
def _inputs(arch: str):
    cfg = registry.reduced(arch)
    return cfg, _masters(cfg), batch_for(cfg, SEQ, BATCH, 0, seed=0)


def _want_layout(cfg, m: int) -> tp.Layout:
    heads = cfg.n_heads % m == 0
    if cfg.family == "hybrid":
        return tp.Layout(attn=True, mlp=True, vocab=True, mixer=True)
    if cfg.family == "ssm":
        return tp.Layout(attn=False, mlp=False, vocab=True, mixer=heads)
    return tp.Layout(attn=heads, mlp=True, vocab=cfg.vocab % m == 0,
                     xattn=heads)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_family_tp_step_matches_1x1(f32, arch, mesh):
    cfg, masters, batch = _inputs(arch)
    shape, kw = MESHES[mesh]
    met, params, state = _mesh_step(cfg, masters, batch, shape, **kw)
    ref = _mesh_step(cfg, masters, batch, (1, 1),
                     microbatches=kw.get("microbatches", 1))
    _assert_close((met, params), ref[:2])
    assert set(met) == set(ref[0])
    for k in ("nll", "z_loss", "ppl_proxy"):
        np.testing.assert_allclose(float(met[k]), float(ref[0][k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert _replicas_equal(state) > 0
    assert all(int(s["step"]) == 1 for s in state.shards)
    assert tp.layout(cfg, state.specs, state.mesh) == _want_layout(
        cfg, shape[1])


def test_xlstm_with_two_heads_a_position_matches_1x1(f32):
    """The reduced xlstm widened to 4 heads on 1x2: two heads a position,
    so `w_if`'s per-head [i, f] cut (`model_cut`) takes more than one
    head's columns; the step held to 1x1's at the file's bounds."""
    cfg = dataclasses.replace(registry.reduced("xlstm-125m"),
                              name="xlstm-4heads", n_heads=4, n_kv_heads=4)
    masters = _masters(cfg)
    batch = batch_for(cfg, SEQ, BATCH, 0, seed=0)
    met, params, state = _mesh_step(cfg, masters, batch, (1, 2))
    ref = _mesh_step(cfg, masters, batch, (1, 1))
    _assert_close((met, params), ref[:2])
    assert tp.layout(cfg, state.specs, state.mesh).mixer
    cut = model_cut(state.mesh, cfg, "blocks.0.mlstm.w_if",
                    state.specs["blocks.0.mlstm.w_if"],
                    tuple(masters["blocks.0.mlstm.w_if"].shape), 1)
    assert sum(s.stop - s.start for s in cut[-1]) == 4


def _reference(arch: str):
    """(reference cfg, its params, its loss function, a numpy batch)."""
    rcfg = rregistry.reduced(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rcfg.vocab, (BATCH, SEQ + 1))
    batch = {"inputs": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    if rcfg.family == "audio":
        batch["frames"] = (0.1 * rng.standard_normal(
            (BATCH, rcfg.encdec.enc_frames, rcfg.d_model))).astype(
                np.float32)
        return (rcfg, rwhisper.init_whisper(jax.random.key(0), rcfg),
                lambda p, b: rwhisper.whisper_loss(p, b, rcfg), batch)
    chunked = rcfg.family == "ssm"
    return (rcfg, rlm.init_lm(jax.random.key(0), rcfg),
            lambda p, b: rlm.lm_loss(p, b, rcfg, mlstm_chunked=chunked),
            batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_tp_1x2_matches_reference(arch):
    """bf16 backbone: the 1x2 "tp" step against the reference's
    one-device step, `test_tp_1x2_matches_reference`'s bounds."""
    rcfg, rp, loss_fn, batch = _reference(arch)
    ocfg = radamw.AdamWConfig()
    want_p, _, want = ref_train_step(loss_fn, rp, radamw.init(rp, ocfg),
                                     batch, 1, ocfg)
    masters = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp))
    met, params, state = _mesh_step(
        registry.reduced(arch), masters,
        {k: torch.from_numpy(v) for k, v in batch.items()}, (1, 2))
    assert tp.layout(registry.reduced(arch), state.specs,
                     state.mesh) is not None
    np.testing.assert_allclose(float(met["loss"]), float(want["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(want["grad_norm"]), rtol=2e-2)
    lr = float(want["lr"])
    got, ref = leaves(convert.lm_params_to_numpy(params)), leaves(want_p)
    assert set(got) == set(ref)
    diff = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert diff.max() <= 2.2 * lr, diff.max() / lr
    assert np.mean(diff <= 0.1 * lr) >= 0.97


# ---------------------------------------------------------------------------
# each sublayer's local form against the whole sublayer
# ---------------------------------------------------------------------------
def _position_leaf(mesh, cfg, name: str, spec: tuple, t: torch.Tensor,
                   f: int) -> torch.Tensor:
    """Position f's tensor of leaf `name` cut from the whole `t`: its
    packed cut's columns, its "model" piece, or the whole leaf."""
    if not model_local(mesh, cfg, name, spec):
        return t
    cut = model_cut(mesh, cfg, name, spec, tuple(t.shape), f)
    if cut is None:
        return t[region(mesh, spec, tuple(t.shape), f)]
    assert all(len(segs) == 1 for segs in cut[:-1])
    return torch.cat([t[..., s] for s in cut[-1]], -1)


def _views(cfg, m: int, module, prefix: str, whole_named: dict) -> list:
    """Each position's view of `module` (named `prefix...` in the model
    whose parameters are `whole_named`) on a 1 x m mesh."""
    mesh = make_mesh((1, m), ("data", "model"), device="cpu")
    specs = make_policy(mesh, cfg).named_param_specs(whole_named)
    named = {n: p.detach() for n, p in module.named_parameters()}
    return [tsteps._view(module, {
        n: _position_leaf(mesh, cfg, prefix + n, specs[prefix + n], t, f)
        for n, t in named.items()}) for f in range(m)]


def _perturb(module, names, seed: int) -> None:
    """Nonzero, unequal values for leaves whose init is constant, so a
    wrong cut of them shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in module.named_parameters():
            if n.split(".")[-1] in names:
                p.add_(0.2 * torch.randn(p.shape, generator=g))


def _x(cfg, seed: int, s: int = SEQ) -> torch.Tensor:
    return torch.randn((2, s, cfg.d_model),
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("m", [2, 4])
def test_mamba2_mixer_partials_sum_to_the_whole(m):
    """Each position's SSM heads (its x, z, dt columns, the whole B and
    C), the norm over all of D_i from the all-reduced sum of squares and
    its `out_proj` rows, all-reduced, against `mamba2_fwd`; float32."""
    cfg = registry.reduced("zamba2-2.7b")
    model = tlm.init_lm(cfg, seed=1, device="cpu")
    blk = model.blocks[0].mamba
    _perturb(blk, ("conv_b", "dt_bias", "d_skip", "scale"), 2)
    views = _views(cfg, m, blk, "blocks.0.mamba.",
                   dict(model.named_parameters()))
    x = _x(cfg, 3)
    lay = tp.Layout(attn=True, mlp=True, vocab=True, mixer=True)
    with torch.no_grad():
        want = tmamba.mamba2_fwd(blk, x, cfg)
        got = tp._mamba(views, [x] * m, cfg, lay)
    assert views[0].in_proj.shape[1] < blk.in_proj.shape[1]
    for y in got:
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(y, got[0])


@pytest.mark.parametrize("m", [2, 4])
def test_shared_block_partials_sum_to_the_whole(m):
    """zamba2's shared block on its own heads (4 over m) and FFN columns
    against `lm._shared_block_fwd`; float32."""
    cfg = registry.reduced("zamba2-2.7b")
    model = tlm.init_lm(cfg, seed=1, device="cpu")
    views = _views(cfg, m, model.shared, "shared.",
                   dict(model.named_parameters()))
    assert views[0].attn.wq.shape[1] * m == model.shared.attn.wq.shape[1]
    x = _x(cfg, 4)
    mask, pos = causal_mask(SEQ), torch.arange(SEQ)
    acfg = tlm._zamba_attn_cfg(cfg)
    lay = tp.Layout(attn=True, mlp=True, vocab=True, mixer=True)
    with torch.no_grad():
        want = tlm._shared_block_fwd(model.shared, x, cfg, mask=mask,
                                     positions=pos)
        xs = tp._attn_sublayer(views, [x] * m, acfg, masks=[mask] * m,
                               positions=[pos] * m, lay=lay)
        got = tp._mlp_sublayer(views, xs, acfg, lay=lay)
    for y in got:
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_mlstm_partials_sum_to_the_whole():
    """The mLSTM on each position's head (xlstm-reduced: 2 heads over 2):
    its channels of up, gate and conv, the gathered up and conv paths,
    its q, k, v and gates, the chunkwise cell and its `down` rows,
    all-reduced, against `mlstm_fwd_chunked`; float32."""
    cfg = registry.reduced("xlstm-125m")
    model = tlm.init_lm(cfg, seed=1, device="cpu")
    blk = model.blocks[0].mlstm
    _perturb(blk, ("conv_b", "b_if"), 2)
    views = _views(cfg, 2, blk, "blocks.0.mlstm.",
                   dict(model.named_parameters()))
    assert views[0].w_if.shape[1] == 2
    x = _x(cfg, 5)
    lay = tp.Layout(attn=False, mlp=False, vocab=True, mixer=True)
    with torch.no_grad():
        want = txlstm.mlstm_fwd_chunked(blk, x, cfg)
        got = tp._mlstm(views, [x, x], cfg, lay)
    for y in got:
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
def test_cross_attention_partials_sum_to_the_whole(m):
    """whisper's cross-attention on each position's heads (4 over m) over
    the encoder's output, against `cross_attention_fwd` of `cross_kv`;
    float32."""
    cfg = registry.reduced("whisper-large-v3")
    model = twhisper.Whisper(cfg, torch.Generator().manual_seed(1))
    blk = model.dec_blocks[0].xattn
    views = _views(cfg, m, blk, "dec_blocks.0.xattn.",
                   dict(model.named_parameters()))
    x, enc = _x(cfg, 6), _x(cfg, 7, s=cfg.encdec.enc_frames)
    lay = tp.Layout(attn=True, mlp=True, vocab=True, xattn=True)
    with torch.no_grad():
        want = twhisper.cross_attention_fwd(blk, x, *twhisper.cross_kv(
            blk, enc, cfg), cfg)
        got = tp._cross_attention(views, [x] * m, [enc] * m, cfg, lay)
    for y in got:
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_gather_broadcast_and_their_grads():
    """`all_gather`'s backward is each part's columns of the summed
    grads; `broadcast`'s the copies' grads summed in position order."""
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn((3, 5, w), generator=g, requires_grad=True)
             for w in (2, 3)]
    outs = tp.all_gather(parts)
    ws = [torch.randn(o.shape, generator=g) for o in outs]
    sum((o * w).sum() for o, w in zip(outs, ws)).backward()
    whole = torch.cat([p.detach() for p in parts], -1)
    assert all(torch.equal(o, whole) for o in outs)
    total = ws[0] + ws[1]
    assert torch.equal(parts[0].grad, total[..., :2])
    assert torch.equal(parts[1].grad, total[..., 2:])
    x = torch.randn((2, 4), generator=g, requires_grad=True)
    ys = tp.broadcast(x, ["cpu"] * 3)
    ws = [torch.randn((2, 4), generator=g) for _ in ys]
    sum((y * w).sum() for y, w in zip(ys, ws)).backward()
    assert all(torch.equal(y, x.detach()) for y in ys)
    assert torch.equal(x.grad, ws[0] + ws[1] + ws[2])


# ---------------------------------------------------------------------------
# which leaves a position holds, and how much
# ---------------------------------------------------------------------------
def test_packed_cuts_hold_their_heads_columns():
    """Full width at 1x4: zamba2's `in_proj` packs [x, z, B, C, dt] (5120,
    5120, 64, 64, 80 columns), so the policy's contiguous quarter of 2612
    columns is not a position's heads: its cut is the x, z and dt
    columns of its 20 heads and the whole B and C; `conv_w` its x and
    B, C; xlstm's `w_if` its head's input and forget gate."""
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    zamba, xl = registry.get("zamba2-2.7b"), registry.get("xlstm-125m")
    for cfg, name, width, want in (
            (zamba, "blocks.0.mamba.in_proj", 10448,
             lambda j: [(1280 * j, 1280 * j + 1280),
                        (5120 + 1280 * j, 6400 + 1280 * j), (10240, 10368),
                        (10368 + 20 * j, 10388 + 20 * j)]),
            (zamba, "blocks.0.mamba.conv_w", 5248,
             lambda j: [(1280 * j, 1280 * j + 1280), (5120, 5248)]),
            (xl, "blocks.0.mlstm.w_if", 8,
             lambda j: [(j, j + 1), (4 + j, 5 + j)])):
        specs = make_policy(mesh, cfg).named_param_specs(
            tsteps.meta_params(cfg))
        spec = specs[name]
        assert model_local(mesh, cfg, name, spec) and spec[-1] == "model"
        shape = tuple(tsteps.meta_params(cfg)[name].shape)
        assert shape[-1] == width
        for j in range(4):
            cut = model_cut(mesh, cfg, name, spec, shape, j)
            assert [(s.start, s.stop) for s in cut[-1]] == want(j)
            assert all(segs == (slice(0, n),)
                       for segs, n in zip(cut[:-1], shape))
            # B / C (and, but at position 3, z and dt) come from others
            assert any(j not in owners for _, owners, _, _ in
                       cut_overlaps(mesh, spec, shape, cut))
    assert model_cut(mesh, zamba, "blocks.0.mamba.out_proj",
                     specs_of(zamba, mesh)["blocks.0.mamba.out_proj"],
                     (5120, 2560), 0) is None


def specs_of(cfg, mesh) -> dict:
    return make_policy(mesh, cfg).named_param_specs(tsteps.meta_params(cfg))


def _layer_bytes(held: dict, cfg) -> int:
    """The bytes of the Mamba2 / mLSTM layers' or whisper's blocks'
    leaves in `held` ({name: bytes})."""
    sub = {"hybrid": ".mamba.", "ssm": ".mlstm."}.get(cfg.family)
    return sum(b for n, b in held.items()
               if (sub in n if sub else n.startswith(("enc_blocks.",
                                                      "dec_blocks."))))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_positions_hold_a_quarter_of_the_layers(arch, capsys):
    """The dry-run's reckoning from the specs at full width on 1x4: the
    largest position's bytes of the Mamba2 / mLSTM layers or whisper's
    blocks against 1x1's (the whole model): under 0.3 of them (a
    quarter, plus the B and C columns each Mamba2 position holds, and
    the norms and biases every position holds)."""
    cfg = registry.get(arch)
    one = dryrun.held_bytes(cfg, Mesh((1, 1), ("data", "model")))
    mesh = Mesh((1, 4), ("data", "model"))
    held = [dryrun.held_bytes(cfg, mesh, position=f) for f in range(4)]
    frac = max(_layer_bytes(h, cfg) for h in held) / _layer_bytes(one, cfg)
    whole = max(sum(h.values()) for h in held) / sum(one.values())
    with capsys.disabled():
        print(f"\n{cfg.name} 1x4: the largest position holds {frac:.4f} of "
              f"1x1's layer bytes, {whole:.4f} of all its leaf bytes")
    assert frac < 0.3
    assert whole < 0.6


@pytest.mark.parametrize("arch", ARCHS)
def test_held_bytes_are_the_dry_runs(f32, arch):
    """`TrainStep.held` after a 1x4 step equals `dryrun.held_bytes` at
    each position; xlstm's positions but the first hold no sLSTM."""
    cfg, masters, batch = _inputs(arch)
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    step = tsteps.make_train_step(cfg, mesh)
    state = tsteps.shard_params({n: t.clone() for n, t in masters.items()},
                                step.policy, step.opt_cfg)
    step.fn(state, batch)
    for f in range(4):
        assert step.held[f] == dryrun.held_bytes(cfg, mesh, position=f)
        assert any(".slstm." in n for n in step.held[f]) == (
            cfg.family == "ssm" and f == 0)


# ---------------------------------------------------------------------------
# the dry-run's count of what the step sends
# ---------------------------------------------------------------------------
RING = {"activation all-reduce": lambda r: 2 * (r - 1) / r,
        "activation all-gather": lambda r: (r - 1) / r,
        "activation reduce-scatter": lambda r: (r - 1) / r,
        "activation broadcast": lambda r: 1.0,
        "activation reduce": lambda r: 1.0}


@pytest.mark.parametrize("shape,fsdp", [((1, 2), False), ((2, 2), True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_counts_what_the_family_step_sends(f32, monkeypatch, arch,
                                                  shape, fsdp):
    """`dryrun.train_collectives` against the calls of one step: each
    gather (the bytes a position reads from others), each activation
    collective (ring bytes of the whole tensor: all-reduce 2 (r - 1) / r,
    all-gather and reduce-scatter (r - 1) / r, broadcast and reduce
    once), forward, in remat's recompute and backward; the gathers
    summed over the positions' own counts."""
    cfg, masters, batch = _inputs(arch)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    sent = {k: [0.0, 0] for k in ("all-gather", *RING)}

    def gathered(nbytes):
        if nbytes > 0:
            sent["all-gather"][0] += nbytes
            sent["all-gather"][1] += 1

    def wrap_whole(shards, mesh_, spec, *a, **k):
        out = whole(shards, mesh_, spec, *a, **k)
        n = shard_count(mesh_, spec)
        gathered((n - 1) / n * out.numel() * out.element_size())
        return out

    def wrap_over(shards, mesh_, spec, *a, **k):
        out = over(shards, mesh_, spec, *a, **k)
        n = shard_count(mesh_, spec) // shard_count(mesh_, kept_spec(spec))
        gathered((n - 1) / n * out.numel() * out.element_size())
        return out

    def wrap_cut(shards, mesh_, spec, cut, flat, *a, **k):
        out = cutter(shards, mesh_, spec, cut, flat, *a, **k)
        shp_ = tuple(s * shard_count(mesh_, (e,))
                     for s, e in zip(shards[0].shape, spec))
        gathered(sum(int(np.prod([s.stop - s.start for s in src]))
                     for _, owners, src, _ in cut_overlaps(mesh_, spec, shp_,
                                                           cut)
                     if flat not in owners) * out.element_size())
        return out

    def wrap(kind, fn, whole_of):
        def inner(*args):
            parts = args[0] if isinstance(args[0], list) else [args[0]]
            r = len(parts) if isinstance(args[0], list) else len(args[1])
            t = whole_of(parts)
            sent[kind][0] += RING[kind](r) * t.numel() * t.element_size()
            sent[kind][1] += 1
            return fn(*args)
        return inner

    first = lambda parts: parts[0]                              # noqa: E731
    joined = lambda parts: torch.cat([p.detach() for p in parts], -1)  # noqa
    whole, over, cutter = (tsteps.gather_shards, tsteps.gather_over,
                           tsteps.gather_cut)
    monkeypatch.setattr(tsteps, "gather_shards", wrap_whole)
    monkeypatch.setattr(tsteps, "gather_over", wrap_over)
    monkeypatch.setattr(tsteps, "gather_cut", wrap_cut)
    for name, kind, of in (
            ("all_reduce", "activation all-reduce", first),
            ("all_reduce_max", "activation all-reduce", first),
            ("all_gather", "activation all-gather", joined),
            ("reduce_scatter", "activation reduce-scatter", first),
            ("broadcast", "activation broadcast", first),
            ("reduce_to", "activation reduce", first)):
        monkeypatch.setattr(tp, name, wrap(kind, getattr(tp, name), of))
    step = tsteps.make_train_step(cfg, mesh, fsdp=fsdp)
    state = tsteps.shard_params({n: t.clone() for n, t in masters.items()},
                                step.policy, step.opt_cfg)
    step.fn(state, batch)
    cell = ShapeSpec("t", "train", SEQ, BATCH)
    wants = [dryrun.train_collectives(cfg, mesh, microbatches=1, fsdp=fsdp,
                                      shape=cell, position=f)
             for f in range(mesh.size)]
    dp = shape[0]
    # the gathers' calls: each leaf's forward all-gather and a block's
    # re-gather for its backward (remat's recompute)
    want_gather = sum(w["bytes"]["all-gather"] + w["bytes"]["re-gather"]
                      for w in wants)
    assert sum(w["count"]["all-gather"] + w["count"]["re-gather"]
               for w in wants) == sent["all-gather"][1]
    np.testing.assert_allclose(want_gather, sent["all-gather"][0],
                               rtol=1e-12)
    want = wants[0]
    for kind in RING:
        assert want["count"][kind] * dp == sent[kind][1], kind
        np.testing.assert_allclose(want["bytes"][kind] * dp, sent[kind][0],
                                   rtol=1e-12, err_msg=kind)
    assert want["bytes"]["activation all-reduce"] > 0
    assert (want["bytes"]["activation broadcast"] > 0) == (
        cfg.family == "ssm")
    assert (want["bytes"]["activation all-gather"] > 0) == (
        cfg.family == "ssm")


def test_run_cell_counts_the_family_train_cells(tmp_path):
    """The train cells of zamba2-2.7b, xlstm-125m and whisper-large-v3
    record their collectives on 16 x 16 (no longer null): zamba2's
    activation all-reduces are the shared block's attention and MLP a
    group, each Mamba2 layer's `out_proj` and norm and the vocabulary's,
    counted call by call."""
    for arch in ARCHS:
        rec = dryrun.run_cell(arch, "train_4k", False, out_dir=tmp_path)
        coll = rec["collectives"]
        assert rec["status"] == "ok" and coll is not None, arch
        assert coll["bytes"]["activation all-reduce"] > 0, arch
        assert coll["total_bytes"] > 0
    cfg = registry.get("zamba2-2.7b")
    rec = dryrun.run_cell("zamba2-2.7b", "train_4k", False,
                          out_dir=tmp_path)
    mb = tshapes.microbatches_for(cfg, tshapes.SHAPES["train_4k"])
    groups = cfg.n_layers // cfg.hybrid.shared_attn_every
    calls = groups * (3 + 2) + cfg.n_layers * (2 + 3) + 2 + 5
    assert rec["collectives"]["count"]["activation all-reduce"] == mb * calls
    xl = dryrun.run_cell("xlstm-125m", "train_4k", False, out_dir=tmp_path)
    # 4 heads do not divide "model" 16: the mLSTM runs whole, the sLSTM
    # once a group
    assert xl["collectives"]["count"]["activation all-gather"] == 0
    assert xl["collectives"]["count"]["activation broadcast"] > 0
