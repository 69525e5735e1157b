"""Tensor parallelism over "model" in the port's mesh train step
(`parallel.tensor_parallel`, `launch.steps.make_train_step(cfg, mesh)`
with `model_strategy="tp"`) on CPU positions.

Arithmetic: with a float32 backbone and compute cast (the `f32` fixture
of `test_torch_sharded_train.py`), a step on 1x2, 1x4 or 2x2 (with and
without FSDP, one or two microbatches) adds the same terms as the 1x1
step in another order: loss, grad norm and every updated master within
rtol 1e-5 / atol 1e-6 of it, replicated pieces bit-equal on their
positions.  The reduced configs cover KV heads that divide the "model"
axis and KV heads that do not (qwen2.5 and qwen3 at 4), MQA whose one
KV head the policy splits inside the head dimension (granite,
paligemma), QKV and MLP biases, learned positions and tied embeddings.
With the bf16 backbone the 1x2 step is held to the reference's
one-device step (`torch_port_helpers.ref_train_step`, unjitted) at
`test_1x1_step_matches_reference`'s bounds.  The hybrid, SSM and audio
families, which ran their loss once a group on leaves gathered whole
until they had a local form, run it on 1x2 here
(`test_torch_family_tensor_parallel.py` holds them in full).  The
dry-run's count of what the step sends is held to the calls the step
makes, counted by wrapping its gather and all-reduce helpers.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.optim import adamw as radamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data.synthetic import batch_for
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.models.common import causal_mask, softmax_cross_entropy
from repro_torch.optim import adamw
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import (holders, kept_spec, make_policy,
                                           model_local, region, shard_count,
                                           shard_slices)
from test_torch_sharded_train import (  # noqa: F401  (f32: a fixture)
    ATOL, RTOL, _assert_close, _masters, _mesh_step, _replicas_equal, f32)
from torch_port_helpers import leaves, ref_train_step

SEQ, BATCH = 32, 4
LOCAL = ("qwen3-8b", "qwen2.5-3b", "codeqwen1.5-7b", "granite-34b",
         "paligemma-3b")
MESHES = {"1x2": ((1, 2), {}), "1x4": ((1, 4), {}), "2x2": ((2, 2), {}),
          "2x2-fsdp": ((2, 2), dict(fsdp=True)),
          "2x2-mb2": ((2, 2), dict(microbatches=2))}


@functools.lru_cache(maxsize=None)
def _inputs(arch: str):
    cfg = registry.reduced(arch)
    return cfg, _masters(cfg), batch_for(cfg, SEQ, BATCH, 0, seed=0)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", LOCAL)
def test_tp_step_matches_1x1(f32, arch, mesh):
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
    lay = tp.layout(cfg, state.specs, state.mesh)
    assert lay == tp.Layout(attn=True, mlp=True, vocab=True)


@pytest.mark.parametrize("arch", ["qwen3-8b", "paligemma-3b"])
def test_tp_step_with_whole_attention(f32, arch):
    """1x8: four heads do not divide 8, so each position runs the
    attention whole (no all-reduce) while the FFN and vocabulary split."""
    cfg, masters, batch = _inputs(arch)
    met, params, state = _mesh_step(cfg, masters, batch, (1, 8))
    _assert_close((met, params), _mesh_step(cfg, masters, batch, (1, 1))[:2])
    assert tp.layout(cfg, state.specs, state.mesh) == tp.Layout(
        attn=False, mlp=True, vocab=True)


def test_tp_1x2_matches_reference():
    """bf16 backbone: the 1x2 "tp" step against the reference's
    one-device step."""
    rcfg, tcfg = rregistry.reduced("qwen3_8b"), registry.reduced("qwen3-8b")
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
        (1, 2))
    np.testing.assert_allclose(float(met["loss"]), float(want["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(want["grad_norm"]), rtol=2e-2)
    lr = float(want["lr"])
    got, ref = leaves(convert.lm_params_to_numpy(params)), leaves(want_p)
    diff = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert diff.max() <= 2.2 * lr, diff.max() / lr
    assert np.mean(diff <= 0.1 * lr) >= 0.97


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m",
                                  "whisper-large-v3"])
def test_gathered_families_on_1x2(f32, arch):
    """The three families that ran gathered (the loss once a group on
    leaves whole) now run the local form on 1x2: a layout, the mixer or
    the cross-attention local, and the step equal to 1x1's."""
    cfg, masters, batch = _inputs(arch)
    got = _mesh_step(cfg, masters, batch, (1, 2))
    want = _mesh_step(cfg, masters, batch, (1, 1))
    _assert_close(got[:2], want[:2])
    lay = tp.layout(cfg, got[2].specs, got[2].mesh)
    assert lay is not None and lay.vocab
    assert lay.xattn if cfg.family == "audio" else lay.mixer


@pytest.mark.parametrize("m", [1, 2, 4])
def test_vocab_parallel_ce_matches_softmax_cross_entropy(m):
    rng = np.random.default_rng(m)
    logits = torch.from_numpy(3 * rng.standard_normal((3, 7, 64))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 64, (3, 7)).astype(np.int32))
    a = logits.clone().requires_grad_(True)
    want, wmet = softmax_cross_entropy(a, labels)
    want.backward()
    b = logits.clone().requires_grad_(True)
    got, gmet = tp.vocab_parallel_ce(list(b.chunk(m, -1)), [labels] * m)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-6)
    for k in wmet:
        np.testing.assert_allclose(float(gmet[k].detach()),
                                   float(wmet[k].detach()), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_parallel_embedding_is_the_lookup(m):
    g = torch.Generator().manual_seed(m)
    emb = torch.randn((64, 16), generator=g)
    tokens = torch.randint(0, 64, (3, 9), generator=g, dtype=torch.int32)
    got = tp.vocab_parallel_embed(list(emb.chunk(m, 0)), [tokens] * m)
    for x in got:
        assert torch.equal(x, emb[tokens].to(tlm.BACKBONE))


def _pieces(mesh, cfg, name: str, spec: tuple, t: torch.Tensor) -> list:
    """Each position's tensor of leaf `name`: its "model" piece where
    the leaf is local, else the whole leaf."""
    m = mesh.shape["model"]
    if not model_local(mesh, cfg, name, spec):
        return [t] * m
    return list(t.chunk(m, spec.index("model")))


@pytest.mark.parametrize("arch,m", [("qwen3-8b", 2), ("qwen3-8b", 4),
                                    ("granite-34b", 2), ("granite-34b", 4),
                                    ("codeqwen1.5-7b", 4)])
def test_local_partials_sum_to_the_whole_layer(arch, m):
    """`attention_fwd` and `mlp_fwd` on each position's pieces (the
    KV heads its queries read where they do not divide m), partials
    summed, against the whole layer; float32."""
    cfg = registry.reduced(arch)
    blk = tlm.init_lm(cfg, seed=1, device="cpu").blocks[0]
    with torch.no_grad():         # nonzero biases, so their split shows
        for n, p in blk.named_parameters():
            if n.split(".")[-1] in ("bq", "bk", "bv", "bi", "bo"):
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    mask, pos = causal_mask(12), torch.arange(12)
    mesh = make_mesh((1, m), ("data", "model"), device="cpu")
    specs = make_policy(mesh, cfg).named_param_specs(
        dict(tlm.init_lm(cfg, seed=1, device="cpu").named_parameters()))
    pieces = {n: _pieces(mesh, cfg, f"blocks.0.{n}", specs[f"blocks.0.{n}"],
                         p.detach())
              for n, p in blk.named_parameters()}
    with torch.no_grad():
        want_a = tattn.attention_fwd(blk.attn, x, cfg, mask=mask,
                                     positions=pos)
        want_f = tmlp.mlp_fwd(blk.ffn, x, cfg)
        views = [tsteps._view(blk, {n: t[j] for n, t in pieces.items()})
                 for j in range(m)]
        got_a = sum(tattn.attention_fwd(tp._local_attention(v.attn, j, m, cfg),
                                        x, cfg, mask=mask, positions=pos)
                    for j, v in enumerate(views))
        got_f = sum(tmlp.mlp_fwd(tp._local_mlp(v.ffn, j), x, cfg,
                                 out_bias=False) for j, v in enumerate(views))
        if cfg.mlp_bias:
            got_f = got_f + blk.ffn.bo
    np.testing.assert_allclose(got_a.numpy(), want_a.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_f.numpy(), want_f.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_kv_heads_of_each_position():
    assert tp.kv_heads_of(1, 2, 32, 8) == [4, 5, 6, 7]    # whole groups
    assert tp.kv_heads_of(3, 4, 16, 2) == [1]             # inside one
    assert tp.kv_heads_of(1, 2, 12, 3) == [1, 1, 2, 2, 2, 2]   # straddles


_WHISPER_LOCAL = {"attn.wq", "attn.bq", "attn.wk", "attn.bk", "attn.wv",
                  "attn.bv", "attn.wo", "ffn.wi", "ffn.wo"}


@pytest.mark.parametrize("arch,m,want", [
    ("qwen3-8b", 4, {"emb", "head", "attn.wq", "attn.wk", "attn.wv",
                     "attn.wo", "ffn.wi", "ffn.wg", "ffn.wo"}),
    ("qwen2.5-3b", 4, {"emb", "head", "attn.wq", "attn.bq", "attn.wo",
                       "ffn.wi", "ffn.wg", "ffn.wo"}),
    ("granite-34b", 2, {"emb", "head", "attn.wq", "attn.bq", "attn.wo",
                        "ffn.wi", "ffn.wo"}),
    ("paligemma-3b", 16, {"emb", "ffn.wi", "ffn.wg", "ffn.wo"}),
    ("zamba2-2.7b", 4, {"emb", "head", "mamba.in_proj", "mamba.conv_w",
                        "mamba.conv_b", "mamba.out_proj", "shared.attn.wq",
                        "shared.attn.wk", "shared.attn.wv", "shared.attn.wo",
                        "shared.ffn.wi", "shared.ffn.wg", "shared.ffn.wo"}),
    ("xlstm-125m", 4, {"emb", "head", "mlstm.up", "mlstm.gate",
                       "mlstm.conv_w", "mlstm.wq", "mlstm.wk", "mlstm.wv",
                       "mlstm.w_if", "mlstm.down"}),
    ("xlstm-125m", 8, {"emb", "head"}),
    ("whisper-large-v3", 2, {"emb"} | {f"{b}.{n}" for b in ("enc", "dec")
                                       for n in _WHISPER_LOCAL}
     | {f"dec.xattn.{n}" for n in ("wq", "wk", "wv", "wo")}),
    ("whisper-large-v3", 4, {f"{b}.{n}" for b in ("enc", "dec")
                             for n in _WHISPER_LOCAL}
     | {f"dec.xattn.{n}" for n in ("wq", "wk", "wv", "wo")})])
def test_which_leaves_are_local(arch, m, want):
    """Full configs: qwen2.5-3b's two KV heads on 4 and granite's one
    (which the policy splits inside the head dimension) stay whole, and
    so do the MLP biases the policy replicates; paligemma's eight heads
    on 16 run whole.  zamba2's Mamba2 leaves the policy splits (80 SSM
    heads over 4; `in_proj`, `conv_w` and `conv_b` local as cuts of
    their packed columns) and its unstacked shared block; xlstm's mLSTM
    but its replicated `conv_b` and `b_if` (its 4 heads do not divide 8:
    whole there) and never the sLSTM; whisper's encoder and decoder
    layers (its 51,866-row tied vocabulary divides 2, not 4), never the
    norms, `pos_emb` or the replicated MLP biases."""
    cfg = registry.get(arch)
    mesh = make_mesh((1, m), ("data", "model"), device="cpu")
    specs = make_policy(mesh, cfg).named_param_specs(tsteps.meta_params(cfg))
    short = {"blocks.0.": "", "enc_blocks.0.": "enc.", "dec_blocks.0.": "dec."}
    got = set()
    for n, s in specs.items():
        first = next((k for k in short if n.startswith(k)), None)
        if (first or n in ("emb", "head") or n.startswith("shared.")) \
                and model_local(mesh, cfg, n, s):
            got.add(n.replace(first, short[first]) if first else n)
    assert got == want
    assert not any(model_local(mesh, cfg, n, s) for n, s in specs.items()
                   if not n.startswith(("blocks.", "enc_blocks.",
                                        "dec_blocks.", "shared.", "emb",
                                        "head")))


def test_gather_over_keeps_the_model_piece():
    cfg = registry.reduced("qwen3-8b")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    step = tsteps.make_train_step(cfg, mesh, fsdp=True)
    masters = _masters(cfg)
    state = tsteps.shard_params(masters, step.policy, step.opt_cfg)
    name = "blocks.0.ffn.wi"
    spec = state.specs[name]
    assert spec == ("data", "model")
    owned = [s["params"][name] for s in state.shards]
    for f in range(4):
        j = mesh.coords(f)["model"]
        got = tsteps.gather_over(owned, mesh, spec, f, "cpu")
        assert torch.equal(got, masters[name].chunk(2, 1)[j])
        cast = tsteps.gather_over(owned, mesh, spec, f, "cpu", torch.bfloat16)
        assert torch.equal(cast, got.to(torch.bfloat16))
    one = make_mesh((1, 2), ("data", "model"), device="cpu")
    st1 = tsteps.shard_params(masters, tsteps.make_train_step(cfg, one).policy,
                              step.opt_cfg)
    mine = st1.shards[1]["params"][name]
    alias = tsteps.gather_over([s["params"][name] for s in st1.shards], one,
                               st1.specs[name], 1, "cpu")
    assert alias.data_ptr() == mine.data_ptr() and not alias.requires_grad


def test_fsdp_is_a_mesh_steps_only():
    cfg = registry.reduced("granite-34b")
    with pytest.raises(ValueError, match="mesh"):
        tsteps.make_train_step(cfg, device="cpu", fsdp=True)


@pytest.mark.parametrize("spec", [("data", None), (None, "model"),
                                  (None, None)])
def test_gathers_read_the_positions_own_pieces(spec):
    """A piece that position f holds is read from f, any other from its
    first holder (replicas marked by their holder show which copy was
    read), and the gather is a detached alias of f's shard where its
    part is that one piece."""
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    whole = torch.arange(32.0).reshape(4, 8)
    shards = [t + 1000 * f for f, t in enumerate(
        tsteps.shard_tensor(whole, mesh, spec))]

    def read_for(f):
        out = whole.clone()
        for key, owners in holders(mesh, spec).items():
            at = shard_slices(mesh, spec, whole.shape, key)
            out[at] += 1000 * (f if f in owners else owners[0])
        return out

    for f in range(mesh.size):
        got = tsteps.gather_shards(shards, mesh, spec, "cpu", flat=f)
        assert torch.equal(got, read_for(f))
        over = tsteps.gather_over(shards, mesh, spec, f, "cpu")
        assert torch.equal(over, read_for(f)[region(mesh, spec, whole.shape,
                                                    f)])
        assert (over.data_ptr() == shards[f].data_ptr()) == (
            spec != ("data", None))
    assert torch.equal(tsteps.gather_shards(shards, mesh, spec, "cpu"),
                       read_for(None))


@pytest.mark.parametrize("shape,fsdp,quant", [
    ((1, 2), False, False), ((2, 2), True, False), ((2, 2), False, False),
    ((1, 2), False, True), ((2, 2), True, True)],
    ids=["shape0-False", "shape1-True", "shape2-False", "1x2-int8",
         "2x2-fsdp-int8"])
def test_dryrun_counts_what_the_step_sends(f32, monkeypatch, shape, fsdp,
                                           quant):
    """`dryrun.train_collectives` on reduced qwen3-8b against the calls
    of one step: each gather (ring bytes (n - 1) / n of what it
    returns, n the pieces it joins) and each all-reduce (2 (r - 1) / r
    of a part, r the group), forward, in remat's recompute and
    backward; with int8 moments, each scale all-reduce of a leaf split
    on its last dimension (r its column pieces; one a moment a step on
    every position)."""
    cfg, masters, batch = _inputs("qwen3-8b")
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    opt = {"opt_cfg": adamw.AdamWConfig(quantized_moments=True)} \
        if quant else {}
    sent = {"all-gather": [0.0, 0], "activation all-reduce": [0.0, 0]}
    scales = [0.0, 0]       # (bytes, position calls) over every position
    inside = []

    def wrap_scales(parts):
        r = len(parts)
        scales[0] += r * 2 * (r - 1) / r * parts[0].numel() \
            * parts[0].element_size()
        scales[1] += r
        inside.append(True)
        try:
            return scale_all_reduce(parts)
        finally:
            inside.pop()

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
            if inside:
                return fn(parts)
            r = len(parts)
            sent["activation all-reduce"][0] += 2 * (r - 1) / r \
                * parts[0].numel() * parts[0].element_size()
            sent["activation all-reduce"][1] += 1
            return fn(parts)
        return inner

    whole, over = tsteps.gather_shards, tsteps.gather_over
    monkeypatch.setattr(tsteps, "gather_shards", wrap_whole)
    monkeypatch.setattr(tsteps, "gather_over", wrap_over)
    monkeypatch.setattr(tp, "all_reduce", wrap_reduce(tp.all_reduce))
    monkeypatch.setattr(tp, "all_reduce_max", wrap_reduce(tp.all_reduce_max))
    scale_all_reduce = tsteps.scale_all_reduce
    monkeypatch.setattr(tsteps, "scale_all_reduce", wrap_scales)
    step = tsteps.make_train_step(cfg, mesh, fsdp=fsdp, **opt)
    state = tsteps.shard_params({n: t.clone() for n, t in masters.items()},
                                step.policy, step.opt_cfg)
    step.fn(state, batch)
    want = dryrun.train_collectives(cfg, mesh, microbatches=1, fsdp=fsdp,
                                    shape=ShapeSpec("t", "train", SEQ, BATCH),
                                    **opt)
    assert want["count"]["scale all-reduce"] * mesh.size == scales[1]
    np.testing.assert_allclose(want["bytes"]["scale all-reduce"] * mesh.size,
                               scales[0], rtol=1e-12)
    assert (scales[1] > 0) == quant
    dp = shape[0]
    per = {"all-gather": mesh.size, "activation all-reduce": dp}
    for kind, (nbytes, calls) in sent.items():
        assert want["count"][kind] * per[kind] == calls, kind
        np.testing.assert_allclose(want["bytes"][kind], nbytes / per[kind],
                                   rtol=1e-12, err_msg=kind)
    assert want["bytes"]["reduce-scatter"] == want["bytes"]["all-gather"]
    assert (want["bytes"]["all-gather"] > 0) == fsdp
    assert want["bytes"]["activation all-reduce"] > 0
