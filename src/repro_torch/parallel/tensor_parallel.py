"""Tensor parallelism over "model" inside one model group of the mesh
train step (`launch.steps.make_train_step(cfg, mesh)`), as Megatron
splits a layer.

Counterpart of the reference's GSPMD partitioning of its jitted train
step under the policy's specs (`repro.launch.steps.make_train_step`,
`repro.parallel.sharding`): XLA splits the products over "model" and
inserts the all-reduces; here they are written out.  A model group is
the `mesh.shape["model"]` positions that share a dp index, and so the
same rows.  Its microbatch runs as one autograd graph over the group's
devices, in lockstep, from this one thread.

Each position j of a group holds its own copy of the residual stream
(every copy the same bits) and its own pieces of the split leaves
(`parallel.sharding.model_local`): the query heads [j H / m, (j + 1) H
/ m) with their output rows, the KV heads those read, the FFN columns
[j F / m, (j + 1) F / m) with their output rows, and the vocabulary rows
[j V / m, (j + 1) V / m) of the embedding and columns of the head.  A
sublayer whose leaves are split so runs on each position's pieces, and
its partial sums are all-reduced (`all_reduce`: each position sums the
group's partials in one fixed order, position 0 first, so every copy
gets the same bits; its backward is the same all-reduce of the grads,
Megatron's conjugate).  A sublayer whose split does not fall on whole
units (heads that do not divide the axis) runs whole on every position,
on leaves gathered whole: the same result, more memory.  A replicated
leaf (norm scales, biases added after a reduction, the learned
positions) is used whole on each position, and its grads are summed
over the group with the dp groups' by the step.

The embedding looks up each position's in-range tokens and writes zeros
for the rest, then all-reduces (adding zeros changes no bit); the
cross-entropy is taken over the split vocabulary (`vocab_parallel_ce`).
The group's loss is a 0-dim tensor on its first position.  Every
family has this form (`FAMILIES`).  The reference's train step reaches
no Pallas kernel, and neither does this: PyTorch and cuBLAS.

The hybrid family (zamba2) runs its weight-shared block as a layer's
attention and MLP (its own head counts; the same local leaves in every
group, their grads summed over the uses by autograd before the step's
reduce) and each Mamba2 mixer on its SSM heads: position j holds the x,
z and dt columns of its heads [j H / m, (j + 1) H / m) in `in_proj` and
the whole B and C (`sharding.model_cut`: the policy's contiguous split
of the packed columns is not per head, so the step gathers exactly
these columns), runs its heads' SSD, all-reduces the float32 sum of
squares (B, S, 1) of its gated channels for the RMSNorm over all of
D_i, and all-reduces the partial of its `out_proj` rows.  The SSM
family (xlstm) runs each mLSTM on its heads: `up`, `gate` and the
depthwise conv on its inner channels, then `all_gather` of the up and
conv paths (B, S, inner) (the projections to q / k / v read every
channel), its heads' q, k, v and gates (`w_if`'s input and forget
columns of its heads), the chunkwise cell, the output gate and the
partial of its `down` rows, all-reduced.  The sLSTM, replicated by the
policy and a loop over time, runs once, on the group's first position,
its output sent to the others by `broadcast` (whose backward sums the
positions' grads in one fixed order); the other positions hold none of
its leaves (`first_only`).  The audio family (whisper) runs its
encoder's layers and its decoder's self-attention and MLP as a layer's,
and each cross-attention on a position's heads: keys and values from
the encoder's output (whole on every position) through its columns of
`xattn.wk` / `wv`, the partial of its `wo` rows all-reduced; its tied
vocabulary is split where it divides the axis.

The MoE family splits its experts over "model" (expert parallelism: the
reference's policy puts the experts' axis on "model" and its activation
rules the dispatched slots' expert axis, so GSPMD runs the dispatch and
the experts' products locally and all-reduces only the combine).  Each
position routes on its own copy of the residual stream; the copies are
the same bits after every all-reduce, so every position of a group
makes the same dispatch decision (`mlp.moe_route` over all E experts)
and builds the same dispatch and combine tensors.  Position j runs only
its experts [j E / m, (j + 1) E / m) on their slots, combines with their
slice of the combine tensor, adds its columns of the always-on FFNs
(`shared`, `dense`) and the group all-reduces once.  A group shares its
rows, so no all-to-all is needed (`parallel.moe_a2a` stays off this
path, as in the reference).  MLA runs its heads locally: each position
computes the whole latent (`w_dkv`, `kv_norm`, `w_kr` whole), its heads'
queries, keys and values from its columns of `wq`, `w_uk` and `w_uv`,
their attention and its rows of `wo`, then the all-reduce.  The router
statistics of a group are its first position's (`mlp.RouterStats`); the
step sums them over the microbatch's dp groups (`router_all_reduce`),
so the load-balance term is the whole microbatch's.
"""
from __future__ import annotations

import dataclasses
import functools
import types

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models import mamba2, mlp, whisper, xlstm
from repro_torch.models.attention import attention_fwd, mla_fwd
from repro_torch.models.common import (apply_norm, causal_mask,
                                       prefix_lm_mask, sinusoidal_positions,
                                       softmax_cross_entropy)
from repro_torch.models.mlp import mlp_fwd
from repro_torch.parallel.sharding import model_local

# the families with a local form: all of them
FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "audio")

# the leaves of each mixer that `Layout.mixer` splits
MIXER_LEAVES = {"hybrid": ("mamba", ("in_proj", "conv_w", "conv_b",
                                     "out_proj")),
                "ssm": ("mlstm", ("up", "gate", "conv_w", "wq", "wk", "wv",
                                  "w_if", "down"))}


@dataclasses.dataclass(frozen=True)
class Layout:
    """Which parts of a group's forward run on each position's pieces
    (partial sums all-reduced): the attention (heads divide the axis;
    MLA's too; the hybrid family's shared block's, whisper's encoder and
    decoder self-attention), the MLP (the FFN width does; the MoE's
    always-on FFNs; the shared block's), the vocabulary (embedding, head
    and cross-entropy), the MoE's experts (their count does), the mixer
    (Mamba2's SSM heads or the mLSTM's heads do) and whisper's
    cross-attention (its heads do).  The others run whole on every
    position."""
    attn: bool
    mlp: bool
    vocab: bool
    experts: bool = False
    mixer: bool = False
    xattn: bool = False


def layout(cfg: ArchConfig, specs: dict, mesh) -> Layout | None:
    """The `Layout` of `cfg` under `specs` (`named_param_specs`) on
    `mesh`'s "model" axis; None for a family outside `FAMILIES`."""
    if cfg.family not in FAMILIES:
        return None

    def loc(name: str) -> bool:
        return model_local(mesh, cfg, name, specs[name])

    vocab = loc("emb")
    if cfg.family == "audio":
        return Layout(attn=loc("enc_blocks.0.attn.wq"),
                      mlp=loc("enc_blocks.0.ffn.wi"), vocab=vocab,
                      xattn=loc("dec_blocks.0.xattn.wq"))
    if cfg.family in MIXER_LEAVES:
        sub, names = MIXER_LEAVES[cfg.family]
        mixer = all(loc(f"blocks.0.{sub}.{n}") for n in names)
        if cfg.family == "ssm":
            return Layout(attn=False, mlp=False, vocab=vocab, mixer=mixer)
        return Layout(attn=loc("shared.attn.wq"), mlp=loc("shared.ffn.wi"),
                      vocab=vocab, mixer=mixer)
    attn = loc("blocks.0.attn.wq")
    if cfg.moe is None:
        return Layout(attn=attn, mlp=loc("blocks.0.ffn.wi"), vocab=vocab)
    always = [f"blocks.0.ffn.{sub}.wi" for sub, on in (
        ("shared", cfg.moe.n_shared), ("dense", cfg.moe.dense_ff)) if on]
    return Layout(attn=attn, mlp=bool(always) and all(map(loc, always)),
                  vocab=vocab, experts=loc("blocks.0.ffn.wi"))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _sum_on(parts, device) -> torch.Tensor:
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        return tuple(_sum_on(parts, p.device) for p in parts)

    @staticmethod
    def backward(ctx, *grads):
        return tuple(all_reduce(list(grads)))


def all_reduce(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of `parts` (one a position of the group, each on its
    device) on each part's device, in one fixed order (part 0 first),
    so every position holds the same bits.  Differentiable: the grad
    of each part is the same all-reduce of the outputs' grads."""
    if len(parts) == 1:
        return list(parts)
    return list(_AllReduce.apply(*parts))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.widths = [p.shape[-1] for p in parts]
        return tuple(torch.cat([q.to(p.device) for q in parts], -1)
                     for p in parts)

    @staticmethod
    def backward(ctx, *grads):
        return tuple(reduce_scatter(list(grads), ctx.widths))


def all_gather(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """`parts` (one a position, each (..., C_j) on its device) joined on
    their last dimension in position order, on each part's device.
    Differentiable: each part's grad is its columns of the sum of the
    outputs' grads (`reduce_scatter`)."""
    if len(parts) == 1:
        return list(parts)
    return list(_AllGather.apply(*parts))


def reduce_scatter(parts: list[torch.Tensor],
                   widths: list[int]) -> list[torch.Tensor]:
    """Position j's columns (`widths[j]` of them, in order) of the sum of
    `parts` (whole tensors, one a position), on its device, summed in
    one fixed order (part 0 first)."""
    out, lo = [], 0
    for p, w in zip(parts, widths):
        out.append(_sum_on([q[..., lo:lo + w] for q in parts], p.device))
        lo += w
    return out


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *devices):
        ctx.device = x.device
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        return (reduce_to(list(grads), ctx.device),) + (None,) * len(grads)


def broadcast(x: torch.Tensor, devices: list) -> list[torch.Tensor]:
    """A copy of `x` on each of `devices` (one a position of the group).
    Differentiable: x's grad is the copies' grads summed in one fixed
    order (`reduce_to`)."""
    if len(devices) == 1:
        return [x]
    return list(_Broadcast.apply(x, *devices))


def reduce_to(parts: list[torch.Tensor], device) -> torch.Tensor:
    """The sum of `parts` (one a position) on `device`, part 0 first."""
    return _sum_on(parts, device)


def all_reduce_max(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise max of `parts` on each part's device (not
    differentiable: the cross-entropy's detached shift)."""
    with torch.no_grad():
        return [functools.reduce(torch.maximum,
                                 [q.to(p.device) for q in parts])
                for p in parts]


# ---------------------------------------------------------------------------
# the split embedding and cross-entropy
# ---------------------------------------------------------------------------
def vocab_parallel_embed(embs: list[torch.Tensor],
                         tokens: list[torch.Tensor]) -> list[torch.Tensor]:
    """`emb[tokens]` in the backbone's dtype (`lm.BACKBONE`) on each
    position, from the rows [j n, (j + 1) n) that position j holds
    (`embs[j]`, n rows): each looks up its in-range tokens, writes
    zeros for the rest, and the group all-reduces (one nonzero term a
    row: the sum is the row)."""
    parts = []
    for j, (e, t) in enumerate(zip(embs, tokens)):
        n = e.shape[0]
        hit = (t >= j * n) & (t < (j + 1) * n)
        rows = e[torch.where(hit, t - j * n, 0)].to(lm.BACKBONE)
        parts.append(torch.where(hit[..., None], rows, 0.0))
    return all_reduce(parts)


def _target_logit(logits: torch.Tensor, labels: torch.Tensor,
                  j: int) -> torch.Tensor:
    n = logits.shape[-1]
    hit = (labels >= j * n) & (labels < (j + 1) * n)
    got = torch.gather(logits, -1,
                       torch.where(hit, labels - j * n, 0)[..., None].long())
    return torch.where(hit, got[..., 0], 0.0)


def vocab_parallel_ce(logits: list[torch.Tensor], labels: list[torch.Tensor],
                      *, z_loss: float = 1e-4) -> tuple[torch.Tensor, dict]:
    """`common.softmax_cross_entropy` over a vocabulary split across the
    group: `logits[j]` (..., V / m) are the columns [j V / m, (j + 1) V /
    m), `labels[j]` the whole labels on position j's device.  In
    float32: `lse` from an all-reduced max (detached) and an all-reduced
    sum of exp, the target logit from the position that holds it, the
    z-loss on `lse`.  Returns (loss, metrics) on position 0's device,
    as `softmax_cross_entropy` does."""
    local = [x.to(torch.float32) for x in logits]
    top = all_reduce_max([x.detach().amax(-1) for x in local])
    sums = all_reduce([torch.exp(x - c[..., None]).sum(-1)
                       for x, c in zip(local, top)])
    target = all_reduce([_target_logit(x, y, j)
                         for j, (x, y) in enumerate(zip(local, labels))])
    lse = torch.log(sums[0]) + top[0]
    nll = lse - target[0]
    zl = z_loss * torch.square(lse)
    loss = torch.mean(nll + zl)
    metrics = {"nll": torch.mean(nll), "z_loss": torch.mean(zl),
               "ppl_proxy": torch.exp(torch.clamp(torch.mean(nll), max=20.0))}
    return loss, metrics


# ---------------------------------------------------------------------------
# a layer on the group
# ---------------------------------------------------------------------------
def kv_heads_of(j: int, m: int, n_heads: int, n_kv: int) -> list[int]:
    """The KV heads that position j's query heads [j H / m, (j + 1) H /
    m) read, in the order `attention_fwd`'s grouping wants them: each
    once where the local heads fill whole GQA groups or sit in one,
    else one a query head (the MHA form, a group of 1)."""
    hl, g = n_heads // m, n_heads // n_kv
    heads = range(j * hl, (j + 1) * hl)
    if hl % g == 0 or g % hl == 0:
        return sorted({q // g for q in heads})
    return [q // g for q in heads]


def _head_columns(t: torch.Tensor, heads: list[int], dh: int) -> torch.Tensor:
    lo, hi = heads[0], heads[-1] + 1
    if heads == list(range(lo, hi)):
        return t[..., lo * dh:hi * dh]
    idx = torch.cat([torch.arange(k * dh, (k + 1) * dh, device=t.device)
                     for k in heads])
    return t.index_select(-1, idx)


def _local_attention(a, j: int, m: int, cfg: ArchConfig):
    """Position j's attention leaves: its own query / output heads as
    they stand; where the KV heads do not divide the axis (whole `wk`,
    `wv`, `bk`, `bv`), the columns of the KV heads its queries read."""
    if cfg.n_kv_heads % m == 0:
        return a
    out = types.SimpleNamespace(**vars(a))
    heads = kv_heads_of(j, m, cfg.n_heads, cfg.n_kv_heads)
    for name in ("wk", "wv", "bk", "bv"):
        if hasattr(a, name):
            setattr(out, name, _head_columns(getattr(a, name), heads,
                                             cfg.resolved_head_dim))
    return out


def _local_mlp(f, j: int):
    """Position j's MLP leaves: `bi`, replicated by the policy, cut to
    the FFN columns its `wi` holds."""
    if not hasattr(f, "bi") or f.bi.shape[0] == f.wi.shape[1]:
        return f
    n = f.wi.shape[1]
    return types.SimpleNamespace(**dict(vars(f), bi=f.bi[j * n:(j + 1) * n]))


def _attention(a, h, j: int, m: int, cfg: ArchConfig, lay: Layout, *,
               mask, positions):
    """Position j's attention on h: its heads' partial sum where
    `lay.attn`, else the whole attention.  MLA and `attention_fwd` read
    their head counts from the weights they are given."""
    if cfg.mla is not None:
        return mla_fwd(a, h, cfg, mask=mask, positions=positions)
    return attention_fwd(_local_attention(a, j, m, cfg) if lay.attn else a,
                         h, cfg, mask=mask, positions=positions)


def _moe(ffns: list, hs: list, cfg: ArchConfig,
         lay: Layout) -> tuple[list, mlp.RouterStats]:
    """The MoE on the group (`mlp.moe_layer`): each position routes its
    copy of h over all the experts and runs its own where `lay.experts`
    (else all of them), the always-on FFNs on its columns where
    `lay.mlp` (else whole); the local parts' sum is all-reduced once and
    the whole parts are added after it, in the reference's order where
    both are local.  Returns (each position's output, the first
    position's `RouterStats`)."""
    n = cfg.moe.n_experts // len(ffns)
    routed = [mlp.moe_routed(f, h, cfg, experts=slice(j * n, (j + 1) * n)
                             if lay.experts else None)
              for j, (f, h) in enumerate(zip(ffns, hs))]
    ys, stats = [y for y, _ in routed], routed[0][1]
    if lay.experts == lay.mlp:
        ys = [mlp.add_always_on(f, h, y, cfg) for f, h, y in zip(ffns, hs, ys)]
        return (all_reduce(ys) if lay.experts else ys), stats
    if lay.experts:
        return [mlp.add_always_on(f, h, y, cfg)
                for f, h, y in zip(ffns, hs, all_reduce(ys))], stats
    extra = all_reduce([mlp.add_always_on(f, h, torch.zeros_like(h), cfg)
                        for f, h in zip(ffns, hs)])
    return [y + e for y, e in zip(ys, extra)], stats


def _attn_sublayer(blocks: list, xs: list, cfg: ArchConfig, *, masks: list,
                   positions: list, lay: Layout) -> list:
    """Each position's residual through `ln1`, its attention partial
    and the all-reduce (where `lay.attn`), added back."""
    hs = [apply_norm(b.ln1, x, cfg.norm) for b, x in zip(blocks, xs)]
    m = len(blocks)
    ys = [_attention(b.attn, h, j, m, cfg, lay, mask=mk, positions=ps)
          for j, (b, h, mk, ps) in enumerate(zip(blocks, hs, masks,
                                                 positions))]
    if lay.attn:
        ys = all_reduce(ys)
    return [x + y for x, y in zip(xs, ys)]


def _mlp_sublayer(blocks: list, xs: list, cfg: ArchConfig, *,
                  lay: Layout) -> list:
    """Each position's residual through `ln2`, its MLP partial, the
    all-reduce and `bo` once (where `lay.mlp`; else the whole MLP),
    added back."""
    hs = [apply_norm(b.ln2, x, cfg.norm) for b, x in zip(blocks, xs)]
    if lay.mlp:
        ys = all_reduce([mlp_fwd(_local_mlp(b.ffn, j), h, cfg, out_bias=False)
                         for j, (b, h) in enumerate(zip(blocks, hs))])
        if cfg.mlp_bias:
            ys = [y + b.ffn.bo.to(y.dtype) for b, y in zip(blocks, ys)]
    else:
        ys = [mlp_fwd(b.ffn, h, cfg) for b, h in zip(blocks, hs)]
    return [x + y for x, y in zip(xs, ys)]


def _block(blocks: list, xs: list, cfg: ArchConfig, *, masks: list,
           positions: list, lay: Layout) -> tuple[list, object]:
    """One layer on the group (`lm._block_fwd`; whisper's encoder layer,
    `whisper._enc_block_fwd`): `_attn_sublayer`, then `_mlp_sublayer`
    (the MoE: `_moe`).  Returns (the positions' outputs, the MoE's
    `RouterStats` or None)."""
    xs = _attn_sublayer(blocks, xs, cfg, masks=masks, positions=positions,
                        lay=lay)
    if cfg.moe is None:
        return _mlp_sublayer(blocks, xs, cfg, lay=lay), None
    hs = [apply_norm(b.ln2, x, cfg.norm) for b, x in zip(blocks, xs)]
    ys, stats = _moe([b.ffn for b in blocks], hs, cfg, lay)
    return [x + y for x, y in zip(xs, ys)], stats


# ---------------------------------------------------------------------------
# the hybrid family: Mamba2 mixers and the shared block
# ---------------------------------------------------------------------------
def _cut(t: torch.Tensor, j: int, m: int) -> torch.Tensor:
    n = t.shape[-1] // m
    return t[..., j * n:(j + 1) * n]


def _local_mamba(p, j: int, m: int):
    """Position j's Mamba2 leaves: its cut of `in_proj`, `conv_w`,
    `conv_b` and its rows of `out_proj` as they stand, and the
    replicated `a_log`, `dt_bias`, `d_skip` and `norm.scale` cut to its
    heads and channels."""
    return types.SimpleNamespace(**dict(
        vars(p), a_log=_cut(p.a_log, j, m), dt_bias=_cut(p.dt_bias, j, m),
        d_skip=_cut(p.d_skip, j, m),
        norm=types.SimpleNamespace(scale=_cut(p.norm.scale, j, m))))


def _mamba(ps: list, hs: list, cfg: ArchConfig, lay: Layout) -> list:
    """The Mamba2 mixer on the group (`mamba2.mamba2_fwd`): where
    `lay.mixer`, each position's heads (`mamba2_mix`), the gated RMSNorm
    over all of D_i from the all-reduced float32 sum of squares, its
    rows of `out_proj` and the all-reduce; else the whole mixer on each
    position."""
    if not lay.mixer:
        return [mamba2.mamba2_fwd(p, h, cfg) for p, h in zip(ps, hs)]
    m = len(ps)
    d_inner = mamba2.dims(cfg)[0]
    local = [_local_mamba(p, j, m) for j, p in enumerate(ps)]
    mixed = [mamba2.mamba2_mix(p, h, cfg) for p, h in zip(local, hs)]
    xf = [(y * F.silu(z)).to(torch.float32) for y, z in mixed]
    del mixed
    ss = all_reduce([torch.sum(t * t, dim=-1, keepdim=True) for t in xf])
    ys = [(t * torch.rsqrt(s / d_inner + mamba2.NORM_EPS) * p.norm.scale)
          .to(h.dtype) @ p.out_proj.to(h.dtype)
          for p, h, t, s in zip(local, hs, xf, ss)]
    return all_reduce(ys)


def _mamba_layer(blocks: list, xs: list, cfg: ArchConfig, *,
                 lay: Layout) -> list:
    """One Mamba2 layer on the group (`lm._block_fwd`'s hybrid branch)."""
    hs = [apply_norm(b.ln1, x, cfg.norm) for b, x in zip(blocks, xs)]
    ys = _mamba([b.mamba for b in blocks], hs, cfg, lay)
    return [x + y for x, y in zip(xs, ys)]


def _hybrid_group(shared: list, layers: list, xs: list, cfg: ArchConfig, *,
                  masks: list, positions: list, lay: Layout,
                  remat: bool) -> list:
    """One group of the hybrid family on the model group
    (`lm._group_fwd`): the shared block as a layer with its own heads
    (`lm._zamba_attn_cfg`), then the group's Mamba2 layers (`layers`,
    each the positions' blocks), each under its own checkpoint when
    `remat`."""
    acfg = lm._zamba_attn_cfg(cfg)
    xs = _attn_sublayer(shared, xs, acfg, masks=masks, positions=positions,
                        lay=lay)
    xs = _mlp_sublayer(shared, xs, acfg, lay=lay)
    for blocks in layers:
        xs = lm._run(remat, _mamba_layer, blocks, xs, cfg, lay=lay)
    return xs


# ---------------------------------------------------------------------------
# the SSM family: (mLSTM, sLSTM) pairs
# ---------------------------------------------------------------------------
def first_only(cfg: ArchConfig, name: str) -> bool:
    """Whether parameter `name` is used by a model group's first position
    only (the others hold none of it): the SSM family's sLSTM and its
    norm `ln2`, which run once a group (`_ssm_pair`)."""
    parts = name.split(".")
    return (cfg.family == "ssm" and parts[0] == "blocks"
            and parts[2] in ("ln2", "slstm"))


def _local_mlstm(p, j: int, m: int):
    """Position j's mLSTM leaves: its columns of `up`, `gate`, `conv_w`,
    `wq`, `wk`, `wv`, its cut of `w_if` and its rows of `down` as they
    stand, the replicated `conv_b` cut to its channels and `b_if` to
    its heads' input and forget gates."""
    i, f = p.b_if.chunk(2)
    return types.SimpleNamespace(**dict(
        vars(p), conv_b=_cut(p.conv_b, j, m),
        b_if=torch.cat([_cut(i, j, m), _cut(f, j, m)])))


def _mlstm(ps: list, hs: list, cfg: ArchConfig, lay: Layout) -> list:
    """The mLSTM on the group (`xlstm.mlstm_fwd_chunked`): where
    `lay.mixer`, each position's inner channels of the up, gate and conv
    paths, `all_gather` of up and conv, its heads' q, k, v and gates,
    the chunkwise cell, the output gate and its rows of `down`, the
    partials all-reduced; else the whole mLSTM on each position."""
    if not lay.mixer:
        return [xlstm.mlstm_fwd_chunked(p, h, cfg) for p, h in zip(ps, hs)]
    m = len(ps)
    local = [_local_mlstm(p, j, m) for j, p in enumerate(ps)]
    ins = [xlstm.mlstm_inputs(p, h) for p, h in zip(local, hs)]
    ups = all_gather([u for u, _, _ in ins])
    convs = all_gather([c for _, _, c in ins])
    ys = []
    for p, h, (_, gate, _), up, conv in zip(local, hs, ins, ups, convs):
        cell = xlstm.mlstm_chunkwise(*xlstm.mlstm_heads(p, up, conv, cfg),
                                     cfg).to(h.dtype)
        ys.append((cell * gate) @ p.down.to(h.dtype))
    return all_reduce(ys)


def _ssm_pair(blocks: list, xs: list, cfg: ArchConfig, *,
              lay: Layout) -> tuple[list, None]:
    """One (mLSTM, sLSTM) pair on the group (`lm._block_fwd`'s SSM
    branch): the mLSTM (`_mlstm`), then the sLSTM once, on the first
    position's residual, its output broadcast to the others."""
    hs = [apply_norm(b.ln1, x, cfg.norm) for b, x in zip(blocks, xs)]
    xs = [x + y for x, y in zip(xs, _mlstm([b.mlstm for b in blocks], hs,
                                           cfg, lay))]
    b0 = blocks[0]
    y = xlstm.slstm_fwd(b0.slstm, apply_norm(b0.ln2, xs[0], cfg.norm), cfg)
    return [x + y for x, y in zip(xs, broadcast(y, [x.device for x in xs]))
            ], None


# ---------------------------------------------------------------------------
# the audio family: whisper
# ---------------------------------------------------------------------------
def _cross_attention(ps: list, hs: list, encs: list, cfg: ArchConfig,
                     lay: Layout) -> list:
    """whisper's cross-attention on the group: each position's heads'
    keys and values from its copy of the encoder's output, its queries,
    and the partial of its `wo` rows, all-reduced (where `lay.xattn`;
    else the whole cross-attention on each position)."""
    ys = [whisper.cross_attention_fwd(p, h, *whisper.cross_kv(p, e, cfg), cfg)
          for p, h, e in zip(ps, hs, encs)]
    return all_reduce(ys) if lay.xattn else ys


def _dec_block(blocks: list, xs: list, encs: list, cfg: ArchConfig, *,
               masks: list, positions: list, lay: Layout) -> list:
    """One decoder layer on the group (`whisper._dec_block_fwd`): the
    self-attention, the cross-attention and the MLP, each as a layer's."""
    xs = _attn_sublayer(blocks, xs, cfg, masks=masks, positions=positions,
                        lay=lay)
    hs = [apply_norm(b.lnx, x, cfg.norm) for b, x in zip(blocks, xs)]
    ys = _cross_attention([b.xattn for b in blocks], hs, encs, cfg, lay)
    xs = [x + y for x, y in zip(xs, ys)]
    return _mlp_sublayer(blocks, xs, cfg, lay=lay)


def _embed(views: list, batches: list, lay: Layout) -> list:
    """The token embeddings on each position in the backbone's dtype: the
    split lookup where `lay.vocab`, else each position's whole one."""
    if lay.vocab:
        return vocab_parallel_embed([v.emb for v in views],
                                    [b["inputs"] for b in batches])
    return [lm.embed_tokens(v.emb, b["inputs"])
            for v, b in zip(views, batches)]


def _cross_entropy(logits: list, batches: list,
                   lay: Layout) -> tuple[torch.Tensor, dict]:
    labels = [b["targets"] for b in batches]
    if lay.vocab:
        return vocab_parallel_ce(logits, labels)
    return softmax_cross_entropy(logits[0], labels[0])


def _whisper_parts(views: list, batches: list[dict], cfg: ArchConfig,
                   lay: Layout, *, remat: bool) -> tuple[torch.Tensor, dict,
                                                         list]:
    """`whisper.whisper_loss`'s cross-entropy with the group's positions
    in lockstep: the encoder's layers (`_block`, every frame attending
    to every frame), its norm on each position, the decoder's layers
    (`_dec_block`) over it, the tied head on each position's vocabulary
    rows (or whole on the first) and the cross-entropy.  Remat covers a
    layer of the whole group, as `encode` and `decode_fwd` do."""
    frames = [b["frames"] for b in batches]
    bb = whisper.BACKBONE
    f, d = frames[0].shape[1:]
    xs = [x.to(bb) + sinusoidal_positions(f, d, x.device).to(bb)[None]
          for x in frames]
    full = [torch.ones((f, f), dtype=torch.bool, device=x.device)
            for x in xs]
    pos = [torch.arange(f, device=x.device) for x in xs]
    for i in range(len(views[0].enc_blocks)):
        layer = lm.joined([v.enc_blocks[i] for v in views])
        xs, _ = lm._run(remat, _block, layer, xs, cfg, masks=full,
                        positions=pos, lay=lay)
    encs = [apply_norm(v.enc_norm, x, cfg.norm) for v, x in zip(views, xs)]
    s = batches[0]["inputs"].shape[1]
    xs = [x + v.pos_emb[:s].to(x.dtype)[None]
          for v, x in zip(views, _embed(views, batches, lay))]
    masks = [causal_mask(s, x.device) for x in xs]
    pos = [torch.arange(s, device=x.device) for x in xs]
    for i in range(len(views[0].dec_blocks)):
        layer = lm.joined([v.dec_blocks[i] for v in views])
        xs = lm._run(remat, _dec_block, layer, xs, encs, cfg, masks=masks,
                     positions=pos, lay=lay)
    logits = []
    for v, x in (zip(views, xs) if lay.vocab else [(views[0], xs[0])]):
        x = apply_norm(v.dec_norm, x, cfg.norm)
        logits.append(x @ v.emb.t().to(x.dtype))      # tied to emb
    loss, metrics = _cross_entropy(logits, batches, lay)
    return loss, metrics, []


def group_loss(views: list, batches: list[dict], cfg: ArchConfig,
               lay: Layout, *, remat: bool) -> tuple[torch.Tensor, dict]:
    """The loss of one group's microbatch with its own aux loss:
    `group_parts`' cross-entropy plus `lm.router_aux` of its statistics,
    (loss + aux, metrics with `aux_loss`) as `lm.lm_loss` returns them."""
    loss, metrics, stats = group_parts(views, batches, cfg, lay, remat=remat)
    aux = lm.router_aux(cfg, stats, loss.device)
    metrics["aux_loss"] = aux
    return loss + aux, metrics


def group_parts(views: list, batches: list[dict], cfg: ArchConfig,
                lay: Layout, *, remat: bool) -> tuple[torch.Tensor, dict,
                                                      list]:
    """The cross-entropy of one group's microbatch: `lm.lm_loss_parts`
    (the VLM's `paligemma.paligemma_loss`: the patches prepended,
    `prefix_lm_mask`, the cross-entropy over the text positions) with the
    group's positions in lockstep.  `views[j]` is position j's model (the
    LM's structure, each leaf its piece or the whole leaf on its device;
    None for a leaf it does not use, `first_only`), `batches[j]` the
    group's rows on its device.  What does not depend on the group is
    `lm`'s own (`embed_inputs`, `final_norm`, `lm_logits`); here are the
    split embedding, the all-reduced blocks (the hybrid family's groups,
    `_hybrid_group`; the SSM family's pairs, `_ssm_pair`) and the split
    cross-entropy; the audio family is `_whisper_parts`.  Remat covers a
    layer of the whole group (`lm._run`; the hybrid family's group, each
    Mamba2 layer under its own inside it).  Returns (loss, metrics, each
    MoE layer's `RouterStats`) on position 0's device."""
    if cfg.family == "audio":
        return _whisper_parts(views, batches, cfg, lay, remat=remat)
    xs = _embed(views, batches, lay)
    xs, prefix = zip(*[lm.embed_inputs(v, x, cfg, b.get("patches"))
                       for v, x, b in zip(views, xs, batches)])
    prefix, s = prefix[0], xs[0].shape[1]
    # a prefix of 0 (the dense family) is the causal mask
    masks = [prefix_lm_mask(s, prefix, x.device) for x in xs]
    positions = [torch.arange(s, device=x.device) for x in xs]
    stats, xs = [], list(xs)
    layers = [lm.joined([v.blocks[i] for v in views])
              for i in range(len(views[0].blocks))]
    if cfg.family == "hybrid":
        per = cfg.hybrid.shared_attn_every
        for g in range(0, len(layers), per):
            xs = lm._run(remat, _hybrid_group, [v.shared for v in views],
                         layers[g:g + per], xs, cfg, masks=masks,
                         positions=positions, lay=lay, remat=remat)
        layers = []
    for layer in layers:
        if cfg.family == "ssm":
            xs, st = lm._run(remat, _ssm_pair, layer, xs, cfg, lay=lay)
        else:
            xs, st = lm._run(remat, _block, layer, xs, cfg, masks=masks,
                             positions=positions, lay=lay)
        if st is not None:
            stats.append(st)
    # the head's columns on each position, else the whole head on the first
    ends = zip(views, xs) if lay.vocab else [(views[0], xs[0])]
    logits = [lm.lm_logits(v, lm.final_norm(v, x, cfg)[:, prefix:], cfg)
              for v, x in ends]
    loss, metrics = _cross_entropy(logits, batches, lay)
    return loss, metrics, stats


def router_all_reduce(parts: list[mlp.RouterStats],
                      device) -> mlp.RouterStats:
    """The sum of one MoE layer's `RouterStats` over the dp groups of a
    microbatch (`parts`, one a group, each on its device) on `device`,
    in group order: the statistics of the whole microbatch.  The counts
    and sums are what an all-reduce over the dp axes sends (2 E + 1
    float32 a layer); the token count is known to every group."""
    out = parts[0]
    out = mlp.RouterStats(*(t.to(device) for t in out[:3]), out.tokens)
    for p in parts[1:]:
        out = mlp.RouterStats(out.claims + p.claims.to(device),
                              out.probs + p.probs.to(device),
                              out.z + p.z.to(device), out.tokens + p.tokens)
    return out


# ---------------------------------------------------------------------------
# what a group sends (the dry-run's count)
# ---------------------------------------------------------------------------
ACTIVATION_KINDS = ("activation all-reduce", "activation all-gather",
                    "activation reduce-scatter", "activation broadcast",
                    "activation reduce")


def activation_collectives(cfg: ArchConfig, lay: Layout, m: int, rows: int,
                           seq: int, *, remat: bool = True
                           ) -> dict[str, tuple[float, int]]:
    """{kind (`ACTIVATION_KINDS`): (bytes a position sends, count)} of one
    microbatch's activation collectives in a group of `m` positions with
    `rows` rows of `seq` tokens, as ring collectives move them: an
    all-reduce 2 (m - 1) / m of the tensor, an all-gather and a
    reduce-scatter (m - 1) / m of the whole tensor, a broadcast and a
    reduce the tensor once (a chain).  In the backbone's dtype unless
    said: a layer's (rows, S, D) attention and MLP partials all-reduced
    forward and their conjugates backward (S with the VLM's patches; the
    MoE's partial is its combine with the always-on FFNs' columns, local
    where the experts or those columns are), and under `remat` the
    attention's again in the recompute (the recompute stops once every
    saved tensor is back, before the MLP's all-reduce, whose sum nothing
    saves; the MoE's is recomputed where whole always-on FFNs run on
    its sum).  The hybrid family: the shared block's attention and MLP
    once a group, as a layer's (its recompute is the group's, which
    stops before the Mamba2 layers' own checkpoints); each Mamba2
    layer's `out_proj` partial forward and backward and the float32
    (rows, S, 1) sum of squares of its norm forward, backward and in its
    recompute.  The SSM family: each mLSTM's `all_gather` of the up and
    conv paths (rows, S, inner) forward and in the recompute, their
    `reduce_scatter` backward, its `down` partial as an attention's; each
    sLSTM's output broadcast forward and its grads reduced backward.
    The audio family: each encoder layer as a layer's over (rows, F, D)
    (F the frames), each decoder layer's self- and cross-attention as
    attentions and its MLP.  Then the embedding's (rows, seq, D) forward
    and backward; the cross-entropy's float32 (rows, seq) max forward,
    sum of exp and target logit forward and backward.  `all_reduce`,
    `all_reduce_max`, `all_gather`, `reduce_scatter`, `broadcast` and
    `reduce_to` make exactly these calls."""
    bb = whisper.BACKBONE if cfg.family == "audio" else lm.BACKBONE
    item = torch.empty((), dtype=bb).element_size()
    act = rows * seq * cfg.d_model * item
    calls = {k: [] for k in ACTIVATION_KINDS}
    ar = calls["activation all-reduce"]
    if cfg.family == "audio":
        enc = rows * cfg.encdec.enc_frames * cfg.d_model * item
        ar += [enc] * ((2 + remat) * lay.attn + 2 * lay.mlp) \
            * cfg.encdec.n_enc_layers
        ar += [act] * ((2 + remat) * (lay.attn + lay.xattn)
                       + 2 * lay.mlp) * cfg.n_layers
    elif cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.hybrid.shared_attn_every
        ar += [act] * ((2 + remat) * lay.attn + 2 * lay.mlp) * groups
        ar += ([act] * 2 + [rows * seq * 4] * (2 + remat)) * lay.mixer \
            * cfg.n_layers
    elif cfg.family == "ssm":
        pairs = lm.n_stacked_layers(cfg)
        whole = rows * seq * xlstm.dims(cfg)[0] * item
        calls["activation all-gather"] += [whole] * (2 + 2 * remat) \
            * lay.mixer * pairs
        calls["activation reduce-scatter"] += [whole] * 2 * lay.mixer * pairs
        ar += [act] * (2 + remat) * lay.mixer * pairs
        calls["activation broadcast"] += [act] * pairs
        calls["activation reduce"] += [act] * pairs
    else:
        prefix = cfg.vlm.n_patches if cfg.family == "vlm" else 0
        ffn, late = lay.mlp, False
        if cfg.moe is not None:
            ffn = lay.experts or lay.mlp
            late = lay.experts and not lay.mlp and bool(
                cfg.moe.n_shared or cfg.moe.dense_ff)
        per_layer = (2 + remat) * lay.attn + (2 + remat * late) * ffn
        ar += [rows * (prefix + seq) * cfg.d_model * item] * (
            per_layer * lm.n_stacked_layers(cfg))
    if lay.vocab:
        ar += [act] * 2
        ar += [rows * seq * 4] * 5
    ring = {"activation all-reduce": 2 * (m - 1) / m,
            "activation all-gather": (m - 1) / m,
            "activation reduce-scatter": (m - 1) / m,
            "activation broadcast": 1.0, "activation reduce": 1.0}
    return {k: (ring[k] * sum(v), len(v)) for k, v in calls.items()}
