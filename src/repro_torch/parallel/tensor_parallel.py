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
The group's loss is a 0-dim tensor on its first position.  The dense,
VLM and MoE families have this form (`FAMILIES`); the step runs every
other family's loss once, on the group's first position, on leaves
gathered whole.  The reference's train step reaches no Pallas kernel,
and neither does this: PyTorch and cuBLAS.

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

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models import mlp
from repro_torch.models.attention import attention_fwd, mla_fwd
from repro_torch.models.common import (apply_norm, prefix_lm_mask,
                                       softmax_cross_entropy)
from repro_torch.models.mlp import mlp_fwd
from repro_torch.parallel.sharding import model_local

# the families with a local form
FAMILIES = ("dense", "vlm", "moe")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Which parts of a group's forward run on each position's pieces
    (partial sums all-reduced): the attention (heads divide the axis;
    MLA's too), the MLP (the FFN width does; the MoE's always-on FFNs),
    the vocabulary (embedding, head and cross-entropy) and the MoE's
    experts (their count does).  The others run whole on every
    position."""
    attn: bool
    mlp: bool
    vocab: bool
    experts: bool = False


def layout(cfg: ArchConfig, specs: dict, mesh) -> Layout | None:
    """The `Layout` of `cfg` under `specs` (`named_param_specs`) on
    `mesh`'s "model" axis; None for every family outside `FAMILIES`."""
    if cfg.family not in FAMILIES:
        return None

    def loc(name: str) -> bool:
        return model_local(mesh, cfg, name, specs[name])

    attn, vocab = loc("blocks.0.attn.wq"), loc("emb")
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


def _block(blocks: list, xs: list, cfg: ArchConfig, *, masks: list,
           positions: list, lay: Layout) -> tuple[list, object]:
    """One layer on the group (`lm._block_fwd`): each position's residual
    through its norm, its attention partial and the all-reduce, then its
    MLP partial, the all-reduce and `bo` once (the MoE: `_moe`).
    Returns (the positions' outputs, the MoE's `RouterStats` or None)."""
    hs = [apply_norm(b.ln1, x, cfg.norm) for b, x in zip(blocks, xs)]
    m = len(blocks)
    ys = [_attention(b.attn, h, j, m, cfg, lay, mask=mk, positions=ps)
          for j, (b, h, mk, ps) in enumerate(zip(blocks, hs, masks,
                                                 positions))]
    if lay.attn:
        ys = all_reduce(ys)
    xs = [x + y for x, y in zip(xs, ys)]
    hs = [apply_norm(b.ln2, x, cfg.norm) for b, x in zip(blocks, xs)]
    stats = None
    if cfg.moe is not None:
        ys, stats = _moe([b.ffn for b in blocks], hs, cfg, lay)
    elif lay.mlp:
        ys = all_reduce([mlp_fwd(_local_mlp(b.ffn, j), h, cfg, out_bias=False)
                         for j, (b, h) in enumerate(zip(blocks, hs))])
        if cfg.mlp_bias:
            ys = [y + b.ffn.bo.to(y.dtype) for b, y in zip(blocks, ys)]
    else:
        ys = [mlp_fwd(b.ffn, h, cfg) for b, h in zip(blocks, hs)]
    return [x + y for x, y in zip(xs, ys)], stats


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
    LM's structure, each leaf its piece or the whole leaf on its device),
    `batches[j]` the group's rows on its device.  What does not depend
    on the group is `lm`'s own (`embed_inputs`, `final_norm`,
    `lm_logits`); here are the split embedding, the all-reduced blocks
    and the split cross-entropy.  Remat covers a layer of the whole
    group (`lm._run`).  Returns (loss, metrics, each MoE layer's
    `RouterStats`) on position 0's device."""
    if lay.vocab:
        xs = vocab_parallel_embed([v.emb for v in views],
                                  [b["inputs"] for b in batches])
    else:
        xs = [lm.embed_tokens(v.emb, b["inputs"])
              for v, b in zip(views, batches)]
    xs, prefix = zip(*[lm.embed_inputs(v, x, cfg, b.get("patches"))
                       for v, x, b in zip(views, xs, batches)])
    prefix, s = prefix[0], xs[0].shape[1]
    # a prefix of 0 (the dense family) is the causal mask
    masks = [prefix_lm_mask(s, prefix, x.device) for x in xs]
    positions = [torch.arange(s, device=x.device) for x in xs]
    stats = []
    for i in range(len(views[0].blocks)):
        xs, st = lm._run(remat, _block, [v.blocks[i] for v in views],
                         list(xs), cfg, masks=masks, positions=positions,
                         lay=lay)
        if st is not None:
            stats.append(st)
    # the head's columns on each position, else the whole head on the first
    ends = zip(views, xs) if lay.vocab else [(views[0], xs[0])]
    logits = [lm.lm_logits(v, lm.final_norm(v, x, cfg)[:, prefix:], cfg)
              for v, x in ends]
    labels = [b["targets"] for b in batches]
    if lay.vocab:
        loss, metrics = vocab_parallel_ce(logits, labels)
    else:
        loss, metrics = softmax_cross_entropy(logits[0], labels[0])
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
def activation_collectives(cfg: ArchConfig, lay: Layout, m: int, rows: int,
                           seq: int, *, remat: bool = True
                           ) -> tuple[float, int]:
    """(bytes a position sends, count) of one microbatch's all-reduces
    in a group of `m` positions with `rows` rows of `seq` tokens, as a
    ring all-reduce moves them (2 (m - 1) / m of the tensor): a layer's
    (rows, S, D) attention and MLP partials in `lm.BACKBONE` forward and
    their conjugates backward (S with the VLM's patches; the MoE's
    partial is its combine with the always-on FFNs' columns, local
    where the experts or those columns are), and under `remat` the
    attention's again in the recompute (the recompute stops once every
    saved tensor is back, before the MLP's all-reduce, whose sum nothing
    saves; the MoE's is recomputed where whole always-on FFNs run on
    its sum); the embedding's (rows, seq, D) forward and backward; the
    cross-entropy's float32 (rows, seq) max forward, sum of exp and
    target logit forward and backward.  `all_reduce` and
    `all_reduce_max` make exactly these calls."""
    item = torch.empty((), dtype=lm.BACKBONE).element_size()
    prefix = cfg.vlm.n_patches if cfg.family == "vlm" else 0
    ffn, late = lay.mlp, False
    if cfg.moe is not None:
        ffn = lay.experts or lay.mlp
        late = lay.experts and not lay.mlp and bool(
            cfg.moe.n_shared or cfg.moe.dense_ff)
    per_layer = (2 + remat) * lay.attn + (2 + remat * late) * ffn
    sizes = [rows * (prefix + seq) * cfg.d_model * item] * (
        per_layer * lm.n_stacked_layers(cfg))
    if lay.vocab:
        sizes += [rows * seq * cfg.d_model * item] * 2
        sizes += [rows * seq * 4] * 5
    return 2 * (m - 1) / m * sum(sizes), len(sizes)
