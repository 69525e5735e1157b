"""Expert parallelism over "model" in the port's mesh train step: the MoE
family's local form (`parallel.tensor_parallel`: experts and MLA or GQA
heads split over "model", the always-on FFNs by columns, partial sums
all-reduced) and its load-balance loss over the whole microbatch
(`models.mlp.RouterStats`, `models.lm.router_aux`,
`launch.steps.make_train_step(cfg, mesh)`) on CPU positions.

Configs: the reduced deepseek-v2-lite (2 layers, d 64, MLA over 4 heads,
8 experts top-2 of width 48 plus one shared, dispatch groups of 64
tokens) and the reduced arctic (4 heads over 2 KV heads, 8 experts top-2
of width 96 plus a dense residual FFN of 96, groups of 64), both with
plain AdamW moments (the reduced arctic with arctic-480b's own int8
moments, split on their last dimension, is held in
`test_torch_sharded_train.py`).  Batches of 4 x 64 tokens: a dp group's rows a
microbatch are whole dispatch groups on every mesh here.

Arithmetic: with a float32 backbone and compute cast (the `f32` fixture
of `test_torch_sharded_train.py`), a step on 2x1, 2x1 ZeRO-3, 1x2, 1x4,
2x2, 2x2 with FSDP and 2x2 with two microbatches adds the same terms as
the 1x1 step in another order: loss, grad norm, each metric and every
updated master within rtol 1e-5 / atol 1e-6 of it, replicated pieces
bit-equal on their positions, every (token, k) claim, slot and drop the
1x1 step's.  With the bf16 backbone the 2x2 step is held to the
reference's one-device step (`torch_port_helpers.ref_train_step` on
`repro.models.lm.lm_loss` over the whole batch) at
`test_tp_1x2_matches_reference`'s bounds, and the positions of a model
group route on the same bits.  The load-balance term is a product of
two means, so the mean of the dp groups' aux losses is not the
microbatch's: on the 2x1 batch here the two differ by 2.0e-2 relative,
and the step gives the microbatch's.  The dry-run's count of what the
step sends is held to the calls the step makes.
"""
import contextlib
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.data.synthetic import batch_for
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import main as train_main
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.models.common import causal_mask
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import (kept_spec, make_policy,
                                           model_local, shard_count)
from repro_torch.train import trainer
from repro_torch.train.trainer import TrainerConfig
from test_torch_sharded_train import (  # noqa: F401  (f32: a fixture)
    ATOL, RTOL, _assert_close, _masters, _mesh_step, _one_device_step,
    _replicas_equal, f32)
from torch_port_helpers import leaves, ref_train_step

SEQ, BATCH = 64, 4
DEEPSEEK, ARCTIC = "deepseek-v2-lite-16b", "arctic-480b"
# the reduced deepseek with an expert width of 36: on 8 positions its 8
# experts split and its shared FFN (36 columns) does not
NARROW = "deepseek-narrow"
MESHES = {"2x1": ((2, 1), {}),
          "2x1-zero3": ((2, 1), dict(model_strategy="fsdp")),
          "1x2": ((1, 2), {}), "1x4": ((1, 4), {}), "2x2": ((2, 2), {}),
          "2x2-fsdp": ((2, 2), dict(fsdp=True)),
          "2x2-mb2": ((2, 2), dict(microbatches=2))}


def _cfg(arch: str):
    if arch == NARROW:
        cfg = registry.reduced(DEEPSEEK)
        return dataclasses.replace(cfg, name=NARROW, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=36))
    return registry.reduced(arch)


@functools.lru_cache(maxsize=None)
def _inputs(arch: str):
    cfg = _cfg(arch)
    return cfg, _masters(cfg), batch_for(cfg, SEQ, BATCH, 0, seed=0)


@contextlib.contextmanager
def _routes(monkeypatch):
    """Every forward call of `mlp.moe_route` (remat's recompute left
    out) as (its input, top_i, slot, keep), in call order."""
    got = []
    route = tmlp.moe_route

    def recorded(p, xg, m):
        out = route(p, xg, m)
        if torch._C._current_graph_task_id() == -1:   # not in a backward
            got.append((xg.detach().clone(),)
                       + tuple(t.detach().clone() for t in out[3:]))
        return out

    with monkeypatch.context() as mp:
        mp.setattr(tmlp, "moe_route", recorded)
        yield got


def _by_group(calls: list, microbatches: int, groups: int, layers: int,
              m: int) -> np.ndarray:
    """The calls of a step as [microbatch][group][layer][position]: each
    microbatch runs its groups in turn, each group its layers, each layer
    its m positions (one call a layer where the group runs whole)."""
    out = np.empty((microbatches, groups, layers, m), dtype=object)
    assert len(calls) == out.size
    for i, c in enumerate(calls):
        out.flat[i] = c
    return out


def _group_shape(state) -> tuple[int, int]:
    """(dp groups, positions a group that route) of a step's state."""
    mesh = state.mesh
    dp = int(np.prod([mesh.shape[a] for a in state.policy.dp_axes]))
    m = mesh.size // dp
    lay = tp.layout(state.policy.cfg, state.specs, mesh) if m > 1 else None
    return dp, (m if lay is not None else 1)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", [DEEPSEEK, ARCTIC])
def test_ep_step_matches_1x1(f32, monkeypatch, arch, mesh):
    cfg, masters, batch = _inputs(arch)
    shape, kw = MESHES[mesh]
    micro = kw.get("microbatches", 1)
    with _routes(monkeypatch) as got:
        met, params, state = _mesh_step(cfg, masters, batch, shape, **kw)
    with _routes(monkeypatch) as want:
        ref = _mesh_step(cfg, masters, batch, (1, 1), microbatches=micro)
    _assert_close((met, params), ref[:2])
    assert set(met) == set(ref[0])
    for k in ("nll", "z_loss", "aux_loss", "ppl_proxy"):
        np.testing.assert_allclose(float(met[k]), float(ref[0][k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert _replicas_equal(state) > 0
    assert all(int(s["step"]) == 1 for s in state.shards)
    dp, m = _group_shape(state)
    layers = cfg.n_layers
    got = _by_group(got, micro, dp, layers, m)
    want = _by_group(want, micro, 1, layers, 1)
    for i in range(micro):
        for layer in range(layers):
            for t in (1, 2, 3):        # top_i, slot, keep
                whole = torch.cat([got[i, k, layer, 0][t]
                                   for k in range(dp)])
                assert torch.equal(whole, want[i, 0, layer, 0][t]), (i, t)


@pytest.mark.parametrize("arch", [DEEPSEEK, ARCTIC])
def test_moe_1x1_mesh_equals_one_device_step(arch, monkeypatch):
    """Bit for bit (bf16 backbone): the MoE family's path of the mesh
    step (every group's forward, the statistics summed, one backward)
    adds nothing on one position."""
    cfg, masters, batch = _inputs(arch)
    grads = {}
    met, params, _ = _mesh_step(cfg, masters, batch, (1, 1),
                                on_grad=lambda n, g: grads.update({n: g}))
    rmet, rparams, rgrads = _one_device_step(cfg, masters, batch,
                                             monkeypatch)
    assert set(met) == set(rmet)
    for k in met:
        assert torch.equal(met[k], rmet[k]), k
    for n in rparams:
        assert torch.equal(params[n], rparams[n]), n
        assert torch.equal(grads[n], rgrads[n]), n


def test_ep_2x2_matches_reference():
    """bf16 backbone: reduced deepseek's 2x2 "tp" step (experts and MLA
    heads split, two dp groups) against the reference's one-device step
    on the whole batch."""
    rcfg, tcfg = rregistry.reduced("deepseek_v2_lite_16b"), _cfg(DEEPSEEK)
    rp = rlm.init_lm(jax.random.key(0), rcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, rcfg.vocab, (BATCH, SEQ + 1))
    batch = {"inputs": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    ocfg = radamw.AdamWConfig()
    want_p, _, want = ref_train_step(
        lambda p, b: rlm.lm_loss(p, b, rcfg), rp, radamw.init(rp, ocfg),
        batch, 1, ocfg)
    masters = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp))
    met, params, _ = _mesh_step(
        tcfg, masters, {k: torch.from_numpy(v) for k, v in batch.items()},
        (2, 2))
    np.testing.assert_allclose(float(met["loss"]), float(want["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(want["grad_norm"]), rtol=2e-2)
    lr = float(want["lr"])
    got, ref = leaves(convert.lm_params_to_numpy(params)), leaves(want_p)
    diff = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert diff.max() <= 2.2 * lr, diff.max() / lr
    assert np.mean(diff <= 0.1 * lr) >= 0.97


def test_load_balance_is_the_whole_microbatchs(f32):
    """The mean of the two dp groups' aux losses differs from the whole
    batch's by far more than the tolerance; the 2x1 step's `aux_loss`
    and loss are the whole batch's (the mean of the halves'
    cross-entropies plus the whole batch's aux)."""
    cfg, masters, batch = _inputs(DEEPSEEK)
    model = tlm.init_lm(cfg, seed=0, device="cpu")
    model.load_state_dict(masters)
    half = BATCH // 2
    with torch.no_grad():
        whole = tlm.lm_loss(model, batch, cfg)[1]["aux_loss"]
        parts = [tlm.lm_loss_parts(model, {k: v[h * half:(h + 1) * half]
                                           for k, v in batch.items()}, cfg)
                 for h in range(2)]
    per_group = [tlm.router_aux(cfg, st, "cpu") for _, _, st in parts]
    mean = (per_group[0] + per_group[1]) / 2
    assert abs(float(mean - whole)) > 100 * RTOL * abs(float(whole))
    met = _mesh_step(cfg, masters, batch, (2, 1))[0]
    np.testing.assert_allclose(float(met["aux_loss"]), float(whole),
                               rtol=RTOL)
    ce = (parts[0][0] + parts[1][0]) / 2
    np.testing.assert_allclose(float(met["loss"]), float(ce + whole),
                               rtol=RTOL)


def _pieces(mesh, cfg, name: str, spec: tuple, t: torch.Tensor) -> list:
    """Each position's tensor of leaf `name`: its "model" piece where
    the leaf is local, else the whole leaf."""
    m = mesh.shape["model"]
    if not model_local(mesh, cfg, name, spec):
        return [t] * m
    return list(t.chunk(m, spec.index("model")))


def _block_views(cfg, m: int):
    """(layer 0 of a seeded model, each of m positions' view of it, the
    `Layout` on a 1 x m mesh)."""
    model = tlm.init_lm(cfg, seed=1, device="cpu")
    blk = model.blocks[0]
    mesh = make_mesh((1, m), ("data", "model"), device="cpu")
    specs = make_policy(mesh, cfg).named_param_specs(
        dict(model.named_parameters()))
    pieces = {n: _pieces(mesh, cfg, f"blocks.0.{n}", specs[f"blocks.0.{n}"],
                         p.detach())
              for n, p in blk.named_parameters()}
    views = [tsteps._view(blk, {n: t[j] for n, t in pieces.items()})
             for j in range(m)]
    return blk, views, tp.layout(cfg, specs, mesh)


@pytest.mark.parametrize("arch,m,experts,mlp", [
    (DEEPSEEK, 2, True, True), (DEEPSEEK, 4, True, True),
    (ARCTIC, 2, True, True), (ARCTIC, 4, True, True),
    (DEEPSEEK, 16, False, True), (NARROW, 8, True, False)])
def test_moe_partials_sum_to_the_whole_layer(arch, m, experts, mlp):
    """The MoE on a group (`tensor_parallel._moe`) against the whole
    layer (`mlp.moe_layer`), float32: each position's output within rtol
    1e-5 / atol 1e-6, the router statistics equal.  Where the experts
    and the always-on FFN both split, the positions' partials (their
    experts' combine plus their columns) summed are the layer; 16
    positions run reduced deepseek's 8 experts whole beside its split
    shared FFN, and the narrow variant's 36 shared columns run whole on
    8 positions beside its split experts."""
    cfg = _cfg(arch)
    blk, views, lay = _block_views(cfg, m)
    assert (lay.experts, lay.mlp) == (experts, mlp)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        want, wst = tmlp.moe_layer(blk.ffn, x, cfg)
        got, st = tp._moe([v.ffn for v in views], [x] * m, cfg, lay)
        for y in got:
            np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-6)
        for a, b in zip(st, wst):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        if experts and mlp:
            n = cfg.moe.n_experts // m
            parts = [tmlp.add_always_on(v.ffn, x, tmlp.moe_routed(
                v.ffn, x, cfg, experts=slice(j * n, (j + 1) * n))[0], cfg)
                for j, v in enumerate(views)]
            np.testing.assert_allclose(sum(parts).numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,m", [(DEEPSEEK, 2), (DEEPSEEK, 4),
                                    (ARCTIC, 2), (ARCTIC, 4)])
def test_attention_partials_sum_to_the_whole_layer(arch, m):
    """MLA on each position's heads (the whole latent, its columns of
    `wq` / `w_uk` / `w_uv`, its rows of `wo`), and arctic's GQA (on 4,
    the KV head each position's queries read), partials summed against
    the whole attention; float32."""
    cfg = _cfg(arch)
    blk, views, lay = _block_views(cfg, m)
    assert lay.attn
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4))
    mask, pos = causal_mask(12), torch.arange(12)
    fwd = tattn.mla_fwd if cfg.mla is not None else tattn.attention_fwd
    with torch.no_grad():
        want = fwd(blk.attn, x, cfg, mask=mask, positions=pos)
        got = sum(tp._attention(v.attn, x, j, m, cfg, lay, mask=mask,
                                positions=pos) for j, v in enumerate(views))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch,shape", [(DEEPSEEK, (1, 4)),
                                        (DEEPSEEK, (2, 2)),
                                        (ARCTIC, (1, 4))])
def test_positions_of_a_group_route_alike(monkeypatch, arch, shape):
    """bf16 backbone: the m positions of a model group route on the same
    bits (each its own copy of the residual stream, equal after every
    all-reduce) and make the same dispatch decision: claims, slots and
    drops equal, layer by layer."""
    cfg, masters, batch = _inputs(arch)
    with _routes(monkeypatch) as calls:
        state = _mesh_step(cfg, masters, batch, shape)[2]
    dp, m = _group_shape(state)
    assert m == shape[1] > 1
    calls = _by_group(calls, 1, dp, cfg.n_layers, m)
    for k in range(dp):
        for layer in range(cfg.n_layers):
            first = calls[0, k, layer, 0]
            for j in range(1, m):
                for a, b in zip(first, calls[0, k, layer, j]):
                    assert torch.equal(a, b), (k, layer, j)


@pytest.mark.parametrize("arch,m,want", [
    (DEEPSEEK, 2, "mla"), (DEEPSEEK, 4, "mla"), (DEEPSEEK, 8, "mla"),
    (ARCTIC, 2, "gqa"), (ARCTIC, 4, "gqa"), (ARCTIC, 8, "gqa"),
    (ARCTIC, 16, "experts")])
def test_which_moe_leaves_are_local(arch, m, want):
    """Full configs: deepseek's MLA heads (16) split with their up- and
    output projections while the latent's down-projection, its norm,
    the rope key and the router stay whole; its 64 experts and 2816
    shared columns split; arctic's 56 heads over 8 KV heads split on 2,
    4 and 8 positions and run whole on 16, where its 128 experts and
    dense FFN still split."""
    sets = {"mla": {"attn.wq", "attn.w_uk", "attn.w_uv", "attn.wo",
                    "ffn.wi", "ffn.wg", "ffn.wo", "ffn.shared.wi",
                    "ffn.shared.wg", "ffn.shared.wo"},
            "gqa": {"attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.wi",
                    "ffn.wg", "ffn.wo", "ffn.dense.wi", "ffn.dense.wg",
                    "ffn.dense.wo"},
            "experts": {"ffn.wi", "ffn.wg", "ffn.wo", "ffn.dense.wi",
                        "ffn.dense.wg", "ffn.dense.wo"}}
    cfg = registry.get(arch)
    mesh = make_mesh((1, m), ("data", "model"), device="cpu")
    specs = make_policy(mesh, cfg).named_param_specs(tsteps.meta_params(cfg))
    got = {n.replace("blocks.0.", "") for n, s in specs.items()
           if n.split(".")[:2] in (["blocks", "0"], ["emb"], ["head"])
           and model_local(mesh, cfg, n, s)}
    assert got == sets[want] | {"emb", "head"}
    assert tp.layout(cfg, specs, mesh) == tp.Layout(
        attn=want != "experts", mlp=True, vocab=True, experts=True)


def test_what_the_moe_step_refuses():
    """Dispatch groups split across dp groups raise `ValueError` (2 x 16
    tokens a group a microbatch against groups of 64), on 2x1 and with 2
    microbatches on 2x2; one dp group (1x2) takes any batch the
    one-device step takes.  Arctic's own int8 moments, split on their
    last dimension on 2x2-FSDP, no longer refuse: the step builds, with
    the leaves whose block scales its positions all-reduce."""
    cfg = _cfg(DEEPSEEK)
    masters = _masters(cfg)
    for shape, micro, seq in (((2, 1), 1, 16), ((2, 2), 2, 32)):
        step = tsteps.make_train_step(
            cfg, make_mesh(shape, ("data", "model"), device="cpu"),
            microbatches=micro)
        state = tsteps.shard_params(masters, step.policy, step.opt_cfg)
        with pytest.raises(ValueError, match="dispatch groups"):
            step.fn(state, batch_for(cfg, seq, 4, 0, seed=0))
    step = tsteps.make_train_step(cfg, make_mesh((1, 2), ("data", "model"),
                                                 device="cpu"))
    state = tsteps.shard_params(masters, step.policy, step.opt_cfg)
    _, met = step.fn(state, batch_for(cfg, 16, 4, 0, seed=0))
    assert np.isfinite(float(met["loss"]))
    own = tsteps.default_opt_cfg(registry.get(ARCTIC))
    step = tsteps.make_train_step(
        _cfg(ARCTIC), make_mesh((2, 2), ("data", "model"), device="cpu"),
        fsdp=True, opt_cfg=own)
    specs = step.policy.named_param_specs(tsteps._master_named(
        _cfg(ARCTIC), tsteps.meta_params(_cfg(ARCTIC))))
    assert own.quantized_moments and tsteps.split_last(step.policy.mesh,
                                                       specs, own)


@pytest.mark.parametrize("arch,shape,fsdp", [
    (DEEPSEEK, (1, 2), False), (DEEPSEEK, (2, 2), True),
    (DEEPSEEK, (2, 2), False), (ARCTIC, (1, 4), False),
    (ARCTIC, (2, 1), False), (DEEPSEEK, (1, 16), False),
    (NARROW, (1, 8), False)])
def test_dryrun_counts_what_the_moe_step_sends(f32, monkeypatch, arch, shape,
                                               fsdp):
    """`dryrun.train_collectives` on the MoE family against the calls of
    one step: each gather (ring bytes (n - 1) / n of what it returns, n
    the pieces it joins), each all-reduce of a model group (2 (r - 1) /
    r of a part, r the group; the combine's is in remat's recompute only
    where whole always-on FFNs run on its sum, the narrow variant on 8)
    and each router statistics' all-reduce over the dp groups (2 (dp -
    1) / dp of a group's statistics)."""
    cfg, masters, batch = _inputs(arch)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    sent = {"all-gather": [0.0, 0], "activation all-reduce": [0.0, 0],
            "router all-reduce": [0.0, 0]}

    def gathered(out, n):
        if n > 1:
            sent["all-gather"][0] += (n - 1) / n * out.numel() \
                * out.element_size()
            sent["all-gather"][1] += 1

    def wrap_whole(shards, mesh_, spec, *a, **k):
        out = whole(shards, mesh_, spec, *a, **k)
        gathered(out, shard_count(mesh_, spec))
        return out

    def wrap_over(shards, mesh_, spec, *a, **k):
        out = over(shards, mesh_, spec, *a, **k)
        gathered(out, shard_count(mesh_, spec)
                 // shard_count(mesh_, kept_spec(spec)))
        return out

    def wrap_reduce(fn):
        def inner(parts):
            r = len(parts)
            sent["activation all-reduce"][0] += 2 * (r - 1) / r \
                * parts[0].numel() * parts[0].element_size()
            sent["activation all-reduce"][1] += 1
            return fn(parts)
        return inner

    def wrap_router(parts, device):
        d = len(parts)
        if d > 1:
            sent["router all-reduce"][0] += 2 * (d - 1) / d * sum(
                t.numel() * t.element_size() for t in parts[0][:3])
            sent["router all-reduce"][1] += 1
        return router(parts, device)

    whole, over, router = (tsteps.gather_shards, tsteps.gather_over,
                           tp.router_all_reduce)
    monkeypatch.setattr(tsteps, "gather_shards", wrap_whole)
    monkeypatch.setattr(tsteps, "gather_over", wrap_over)
    monkeypatch.setattr(tp, "all_reduce", wrap_reduce(tp.all_reduce))
    monkeypatch.setattr(tp, "all_reduce_max", wrap_reduce(tp.all_reduce_max))
    monkeypatch.setattr(tp, "router_all_reduce", wrap_router)
    step = tsteps.make_train_step(cfg, mesh, fsdp=fsdp)
    state = tsteps.shard_params({n: t.clone() for n, t in masters.items()},
                                step.policy, step.opt_cfg)
    step.fn(state, batch)
    want = dryrun.train_collectives(cfg, mesh, microbatches=1, fsdp=fsdp,
                                    shape=tshapes.ShapeSpec("t", "train", SEQ,
                                                           BATCH))
    dp = shape[0]
    per = {"all-gather": mesh.size, "activation all-reduce": dp,
           "router all-reduce": 1}
    for kind, (nbytes, calls) in sent.items():
        assert want["count"][kind] * per[kind] == calls, kind
        np.testing.assert_allclose(want["bytes"][kind], nbytes / per[kind],
                                   rtol=1e-12, err_msg=kind)
    assert want["bytes"]["reduce-scatter"] == want["bytes"]["all-gather"]
    # MLA's latent projections split inside the latent (and arctic's 2 KV
    # heads inside the head dim on 4) are gathered over "model" too
    assert (want["bytes"]["all-gather"] > 0) == (fsdp or shape[1] > 1)
    assert (want["bytes"]["activation all-reduce"] > 0) == (shape[1] > 1)
    assert (want["bytes"]["router all-reduce"] > 0) == (dp > 1)


def test_run_cell_counts_the_moe_train_cells(tmp_path):
    """The MoE family's train cells record the step's collectives on both
    production meshes: the experts' and heads' activations all-reduced
    over "model" 16, the router statistics over the dp axes."""
    for arch in (DEEPSEEK, ARCTIC):
        for multi in (False, True):
            rec = dryrun.run_cell(arch, "train_4k", multi, out_dir=tmp_path)
            coll = rec["collectives"]
            assert rec["status"] == "ok" and coll is not None
            assert coll["bytes"]["activation all-reduce"] > 0
            assert coll["bytes"]["router all-reduce"] > 0
            cfg = registry.get(arch)
            assert coll["count"]["router all-reduce"] == cfg.n_layers \
                * tshapes.microbatches_for(cfg, tshapes.SHAPES["train_4k"])


def _ckpt_leaves(path, step) -> dict:
    empty = trainer._empty_state(_cfg(DEEPSEEK), TrainerConfig(),
                                 torch.device("cpu"))
    tree = ckpt.restore(path, step, convert.train_state_tree(empty,
                                                             spec=True))
    return leaves(jax.tree.map(np.asarray, tree))


def test_train_cli_moe_on_a_mesh_restarts_bitwise(tmp_path):
    """`launch.train --arch deepseek-v2-lite-16b --reduced --mesh 1x2
    --device cpu`: 2 steps then 2 more from the checkpoint end on the
    state of 4 straight steps, leaf for leaf."""
    args = ["--arch", DEEPSEEK, "--reduced", "--mesh", "1x2", "--device",
            "cpu", "--seq", str(SEQ), "--batch", str(BATCH), "--ckpt-every",
            "2"]
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


def test_aux_loss_of_summed_statistics():
    """`mlp.aux_loss` of one batch's `RouterStats` is the reference's
    `_aux_losses` formula (float32 means); the statistics of a batch's
    parts summed (`tensor_parallel.router_all_reduce`) give the whole
    batch's, claims exactly."""
    cfg = _cfg(DEEPSEEK)
    m = cfg.moe
    g = torch.Generator().manual_seed(7)
    logits = torch.randn((4, 64, m.n_experts), generator=g)
    probs = torch.softmax(logits, -1)
    top_i = tmlp._top_k(probs, m.top_k)[1]
    st = tmlp.router_stats(logits, probs, top_i, m)
    onehot = torch.nn.functional.one_hot(top_i, m.n_experts).float()
    frac_tokens = onehot.sum(-2).mean((0, 1))
    lb = m.n_experts * torch.sum(frac_tokens * probs.mean((0, 1))) / m.top_k
    z = torch.mean(torch.square(torch.logsumexp(logits, -1)))
    want = m.router_aux_weight * lb + m.router_z_weight * z
    assert torch.equal(tmlp.aux_loss(m, st), want)
    halves = [tmlp.router_stats(logits[h:h + 2], probs[h:h + 2],
                                top_i[h:h + 2], m) for h in (0, 2)]
    summed = tp.router_all_reduce(halves, "cpu")
    assert torch.equal(summed.claims, st.claims) and summed.tokens == 256
    np.testing.assert_allclose(float(tmlp.aux_loss(m, summed)), float(want),
                               rtol=1e-6)
