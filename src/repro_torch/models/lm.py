"""Decoder-only LM assembled from an ArchConfig: the dense family, the
MoE family (deepseek-v2-lite with MLA, arctic with GQA), the decoder
of the VLM family (paligemma: image patches prepended as a prefix,
`repro_torch.models.paligemma`), the hybrid family (zamba2: Mamba2
layers in groups, one weight-shared attention + FFN block at the start
of every group) and the SSM family (xlstm: (mLSTM, sLSTM) pairs,
`repro_torch.models.xlstm`), with RoPE or learned absolute positions
(granite: `pos_emb`, added to the embedding).  The audio family
(whisper, an encoder-decoder) is `repro_torch.models.whisper`.

Counterpart of `repro.models.lm`: `init_lm` builds the parameters as
`nn.Module`s whose state-dict names follow the reference's pytree
(`emb`, `blocks.<i>.ln1.scale`, `blocks.<i>.attn.wq`,
`blocks.<i>.ffn.router`, ..., `final_norm.scale`, `head`, `pos_emb`;
the hybrid family's `blocks.<i>.mamba.in_proj`, ... and its shared
block's `shared.attn.wq`, ...; the SSM family's `blocks.<i>.mlstm.up`,
`blocks.<i>.slstm.r_gates`, ...), with the reference's stacked `blocks`
axis unrolled into a `ModuleList`.  MoE layers yield their
router statistics (`mlp.RouterStats`); `router_aux` turns a layer's into
its aux loss and sums them over the layers, `lm_hidden` returns that sum
and `lm_loss` adds it to the loss (`lm_loss_parts` leaves the statistics
apart, for a batch split into parts).  `lm_hidden` / `lm_logits`
are the forward of prefill (`repro_torch.launch.steps`), dense or
blockwise, with an optional prefix of embeddings (the VLM's patches),
and `lm_loss` the training loss (`launch.steps
.make_train_step`); `init_decode_state` / `decode_step` the one-token
decode of serving (`repro_torch.serve.engine`); the CIM-in-the-loop
trainer has its own forward (`repro_torch.train.acim_lm`).
`stacked_ndim` gives a parameter the rank of the reference's stacked
leaf, which its dtype and weight-decay rules read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, mlp, xlstm
from repro_torch.models.common import (MAX_LEARNED_POS, apply_norm,
                                       causal_mask, dense_init, embed_init,
                                       init_norm, softmax_cross_entropy)


# The backbone's activation dtype: the reference casts the embeddings to
# bf16 (`astype(jnp.bfloat16)`) whatever the parameters' dtype.  Read by
# `lm_hidden` and `decode_step` at each call, so a float32 backbone can be
# set on both packages to hold their arithmetic tightly.
BACKBONE = torch.bfloat16


# The families this module builds; the audio family's encoder-decoder is
# `models.whisper` (`models.registry.build_model` picks it).
FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm")


def check_dense(cfg: ArchConfig) -> None:
    """Raise `ValueError` unless this module builds `cfg`: the dense
    decoder, the MoE family and the VLM family's decoder, each with GQA
    or MLA attention, with RoPE or learned positions; the hybrid family
    (Mamba2 with a shared attention block) with its `ssm` and `hybrid`
    sub-configs and whole groups of layers; the SSM family (xLSTM) with
    its `xlstm` sub-config and whole (mLSTM, sLSTM) pairs.  The audio
    family is `models.whisper`'s."""
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name!r} is an encoder-decoder (audio): "
                         f"models.whisper builds it, through "
                         f"models.registry.build_model")
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name!r}: unknown family {cfg.family!r}; "
                         f"the LM builds {FAMILIES}")
    if cfg.family == "ssm":
        if cfg.xlstm is None:
            raise ValueError(f"an SSM-family config needs its xlstm "
                             f"sub-config; {cfg.name!r} has none")
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name!r}: {cfg.n_layers} layers are not "
                             f"whole (mLSTM, sLSTM) pairs")
        xlstm.dims(cfg)
        if cfg.d_model % cfg.n_heads:
            raise ValueError(f"{cfg.name!r}: d_model {cfg.d_model} is not a "
                             f"multiple of {cfg.n_heads} sLSTM heads")
    if cfg.family == "hybrid":
        if cfg.ssm is None or cfg.hybrid is None:
            raise ValueError(f"a hybrid-family config needs its ssm and "
                             f"hybrid sub-configs; {cfg.name!r} has ssm="
                             f"{cfg.ssm}, hybrid={cfg.hybrid}")
        if cfg.n_layers % cfg.hybrid.shared_attn_every:
            raise ValueError(f"{cfg.name!r}: {cfg.n_layers} layers are not "
                             f"whole groups of "
                             f"{cfg.hybrid.shared_attn_every}")


class Block(nn.Module):
    """One layer (the reference's `_init_block`): `ln1`, `attn` (MLA
    where the config has it), `ln2`, `ffn` (an MoE where the config has
    one); for the hybrid family `ln1` and the Mamba2 mixer `mamba`
    only; for the SSM family a pair, `ln1`, `mlstm`, `ln2`, `slstm`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.ln1 = init_norm(d, cfg.norm)
        if cfg.family == "ssm":
            self.mlstm = xlstm.init_mlstm(cfg, generator)
            self.ln2 = init_norm(d, cfg.norm)
            self.slstm = xlstm.init_slstm(cfg, generator)
            return
        if cfg.family == "hybrid":
            self.mamba = mamba2.init_mamba2(cfg, generator)
            return
        self.attn = (attn.init_mla(cfg, generator) if cfg.mla is not None
                     else attn.init_attention(cfg, generator))
        self.ln2 = init_norm(d, cfg.norm)
        self.ffn = (mlp.init_moe(d, cfg, generator) if cfg.moe is not None
                    else mlp.init_mlp(d, cfg.d_ff, cfg, generator))


# ---------------------------------------------------------------------------
# shared-attention block (Zamba2)
# ---------------------------------------------------------------------------
def _zamba_attn_cfg(cfg: ArchConfig) -> ArchConfig:
    """The shared block's attention config: the hybrid sub-config's heads,
    head dim d_model / heads (80 for zamba2-2.7b), no bias, no qk-norm."""
    hy = cfg.hybrid
    return dataclasses.replace(cfg, n_heads=hy.attn_heads,
                               n_kv_heads=hy.attn_kv_heads, head_dim=0,
                               attn_bias=False, qk_norm=False)


class SharedBlock(nn.Module):
    """Zamba2's weight-shared block (the reference's
    `_init_shared_block`): `ln1`, `attn` (`_zamba_attn_cfg`), `ln2` and
    the gated FFN `ffn` of width `hybrid.shared_ff`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.ln1 = init_norm(d, cfg.norm)
        self.attn = attn.init_attention(_zamba_attn_cfg(cfg), generator)
        self.ln2 = init_norm(d, cfg.norm)
        self.ffn = mlp.init_mlp(d, cfg.hybrid.shared_ff, cfg, generator)


def _shared_block_fwd(p: SharedBlock, x: torch.Tensor, cfg: ArchConfig, *,
                      mask: torch.Tensor | None, positions: torch.Tensor,
                      attn_impl: str = "dense") -> torch.Tensor:
    acfg = _zamba_attn_cfg(cfg)
    h = apply_norm(p.ln1, x, cfg.norm)
    if attn_impl == "blockwise":
        a = attn.attention_fwd_blockwise(p.attn, h, acfg, positions=positions)
    else:
        a = attn.attention_fwd(p.attn, h, acfg, mask=mask, positions=positions)
    x = x + a
    h = apply_norm(p.ln2, x, cfg.norm)
    return x + mlp.mlp_fwd(p.ffn, h, cfg)


def n_stacked_layers(cfg: ArchConfig) -> int:
    """The length of the reference's stacked `blocks` axis: every layer,
    or for the SSM family every (mLSTM, sLSTM) pair (n_layers / 2)."""
    if cfg.family == "ssm":
        return cfg.n_layers // 2
    return cfg.n_layers


# The reference's stacked subtrees: `blocks` of the LM, whisper's
# `enc_blocks` and `dec_blocks`, each a leading layer axis.
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def stacked_ndim(name: str, t: torch.Tensor) -> int:
    """The rank the reference gives parameter `name` (a state-dict name
    of `LM` or of `whisper.Whisper`).  The reference stacks every
    layer's leaves on a leading layer axis (`blocks.attn.wq` is (L, D,
    H*Dh)), so a tensor under `blocks.<i>.`, `enc_blocks.<i>.` or
    `dec_blocks.<i>.` (`STACKED`) counts its own rank plus one:
    `blocks.<i>.ln1.scale` has rank 2 there, `final_norm.scale` rank 1,
    and so have the hybrid family's unstacked `shared.ln1.scale` and
    whisper's `enc_norm.scale`.  The reference's rules that test `ndim
    >= 2` read this rank: the serving cast (`_to_serving_dtype`),
    AdamW's weight decay and the train step's `cast_bf16`."""
    return t.dim() + (1 if name.split(".", 1)[0] in STACKED else 0)


def _serving(name: str, t: torch.Tensor, device: torch.device,
             dtype: torch.dtype | None) -> torch.Tensor:
    """`t` on `device`; a float tensor of stacked rank >= 2 cast to
    `dtype` when one is given (the reference's `_to_serving_dtype` on
    its stacked tree: every layer's matrices, experts, norm scales and
    biases go to bf16; `final_norm.scale` stays float32)."""
    t = t.to(device)
    if dtype is not None and stacked_ndim(name, t) >= 2 \
            and t.is_floating_point():
        t = t.to(dtype)
    return t


def _place(module: nn.Module, prefix: str, device: torch.device,
           dtype: torch.dtype | None, place=None) -> nn.Module:
    """`module`'s parameters (named `prefix` + their names) moved and
    cast by `_serving`, then each passed to `place(name, tensor)`, where
    given, which returns the tensor the module keeps (a mesh's state
    takes each leaf's pieces and leaves the module's tensors empty)."""
    for name, prm in module.named_parameters():
        prm.data = _serving(prefix + name, prm.data, device, dtype)
        if place is not None:
            prm.data = place(prefix + name, prm.data)
    return module


def _leaf(name: str, t: torch.Tensor, device: torch.device,
          dtype: torch.dtype | None, place=None) -> nn.Parameter:
    """A parameter outside the layers, as `_place` treats a layer's."""
    t = _serving(name, t, device, dtype)
    return nn.Parameter(t if place is None else place(name, t))


class LM(nn.Module):
    """Parameters drawn from `generator` in a fixed order (embedding,
    layer 0, ..., layer L-1, final norm, head, the learned positions'
    table `pos_emb` (MAX_LEARNED_POS, D), the hybrid family's shared
    block), on the generator's device.  Each part is moved to
    `device` (default: the CPU) and cast as `_serving` says right after
    it is drawn, so the drawing device holds one layer in float32 at a
    time.  `place` as `_place`'s."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device: torch.device | None = None,
                 dtype: torch.dtype | None = None, place=None):
        super().__init__()
        check_dense(cfg)
        dev = torch.device("cpu" if device is None else device)
        self.emb = _leaf("emb", embed_init(
            generator, (cfg.vocab, cfg.d_model)), dev, dtype, place)
        self.blocks = nn.ModuleList(
            _place(Block(cfg, generator), f"blocks.{i}.", dev, dtype, place)
            for i in range(n_stacked_layers(cfg)))
        self.final_norm = _place(init_norm(cfg.d_model, cfg.norm),
                                 "final_norm.", dev, dtype, place)
        if not cfg.tie_embeddings:
            self.head = _leaf("head", dense_init(
                generator, (cfg.d_model, cfg.vocab)), dev, dtype, place)
        if cfg.pos == "learned":
            self.pos_emb = _leaf("pos_emb", embed_init(
                generator, (MAX_LEARNED_POS, cfg.d_model)), dev, dtype, place)
        if cfg.family == "hybrid":
            self.shared = _place(SharedBlock(cfg, generator), "shared.", dev,
                                 dtype, place)


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None,
            dtype: torch.dtype | None = None, draw_on=None,
            place=None) -> LM:
    """Parameters from a `torch.Generator` seeded with `seed`, on
    `device` (CUDA when None, raising without it).  `dtype=torch.bfloat16`
    gives the serving weights.

    By default the generator is the CPU's, so one seed gives the same
    weights on every device: qwen2.5-3b's 3.4 G truncated normals take
    about half a minute on an 8-core host with PyTorch 2.11, and each
    layer is moved as it is drawn.  `draw_on` names another device to
    draw on (a generator of that device, seeded with `seed`): on the
    card, deepseek-v2-lite's 16.2 G draw in seconds, but the weights
    are not the CPU draw's.  `place` is `_place`'s: a mesh's state
    splits each leaf as it is drawn (`launch.steps.init_mesh_state`)."""
    dev = resolve_device(device)
    g = torch.Generator(device="cpu" if draw_on is None else draw_on)
    return LM(cfg, g.manual_seed(seed), device=dev, dtype=dtype, place=place)


def _block_fwd(p: Block, x: torch.Tensor, cfg: ArchConfig, *,
               mask: torch.Tensor | None, positions: torch.Tensor,
               attn_impl: str = "dense", prefix_len: int = 0,
               mlstm_chunked: bool = False
               ) -> tuple[torch.Tensor, mlp.RouterStats | None]:
    """One layer: (y, the MoE's `RouterStats`, None without an MoE).
    attn_impl: 'dense' | 'blockwise' (32k+ seqs); a hybrid layer (Mamba2)
    and an SSM pair (mLSTM, then sLSTM; the mLSTM chunkwise when
    `mlstm_chunked`) have no attention."""
    if attn_impl not in ("dense", "blockwise"):
        raise ValueError(f"attn_impl must be 'dense' or 'blockwise', not "
                         f"{attn_impl!r}")
    h = apply_norm(p.ln1, x, cfg.norm)
    if cfg.family in ("hybrid", "ssm"):
        if cfg.family == "hybrid":
            return x + mamba2.mamba2_fwd(p.mamba, h, cfg), None
        fwd = xlstm.mlstm_fwd_chunked if mlstm_chunked else xlstm.mlstm_fwd
        x = x + fwd(p.mlstm, h, cfg)
        h = apply_norm(p.ln2, x, cfg.norm)
        return x + xlstm.slstm_fwd(p.slstm, h, cfg), None
    if cfg.mla is not None:
        if attn_impl == "blockwise":
            a = attn.mla_fwd_blockwise(p.attn, h, cfg, positions=positions)
        else:
            a = attn.mla_fwd(p.attn, h, cfg, mask=mask, positions=positions)
    elif attn_impl == "blockwise":
        a = attn.attention_fwd_blockwise(p.attn, h, cfg, positions=positions,
                                         prefix_len=prefix_len)
    else:
        a = attn.attention_fwd(p.attn, h, cfg, mask=mask, positions=positions)
    x = x + a
    h = apply_norm(p.ln2, x, cfg.norm)
    if cfg.moe is not None:
        y, stats = mlp.moe_layer(p.ffn, h, cfg)
        return x + y, stats
    return x + mlp.mlp_fwd(p.ffn, h, cfg), None


class Deferred:
    """A block's parameters that are not at hand until the block runs (a
    mesh step's gathered leaves, `launch.steps`): `_run` calls `open()`
    inside the call and passes what it returns in its place.  Under
    remat that is inside the checkpointed region, so the leaves die with
    the block's forward and its recompute opens them again; without
    remat the call runs under `keep()`, a context for the tensors its
    graph saves.  A subclass defines both."""

    def open(self):
        raise NotImplementedError

    def keep(self):
        raise NotImplementedError


class _Joined(Deferred):
    """A list of blocks (one a position of a model group) opened
    together."""

    def __init__(self, parts: list):
        self.parts = parts

    def open(self) -> list:
        return [p.open() if isinstance(p, Deferred) else p
                for p in self.parts]

    def keep(self):
        return next(p for p in self.parts if isinstance(p, Deferred)).keep()


def joined(parts: list):
    """`parts` as one `Deferred` where any of them is one, else as they
    are (a layer of a model group, `parallel.tensor_parallel`)."""
    if any(isinstance(p, Deferred) for p in parts):
        return _Joined(parts)
    return parts


def _opened(fn, checkpointed: bool, *args, **kw):
    """`fn` on `args` with each `Deferred` opened (`Deferred`)."""
    kept = next(a for a in args if isinstance(a, Deferred))
    with contextlib.nullcontext() if checkpointed else kept.keep():
        return fn(*(a.open() if isinstance(a, Deferred) else a
                    for a in args), **kw)


def _run(checkpointed: bool, fn, *args, **kw):
    """`fn(*args, **kw)`, under `torch.utils.checkpoint` when
    `checkpointed`: backward keeps the call's tensor inputs and
    recomputes the rest.  A `Deferred` argument is opened inside the
    call."""
    if any(isinstance(a, Deferred) for a in args):
        fn = functools.partial(_opened, fn, checkpointed)
    if checkpointed:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return fn(*args, **kw)


def _group_fwd(shared: SharedBlock, blocks, x: torch.Tensor,
               cfg: ArchConfig, *, mask: torch.Tensor | None,
               positions: torch.Tensor, attn_impl: str,
               remat: bool) -> torch.Tensor:
    """One group of the hybrid family: the shared block, then its
    Mamba2 layers `blocks`, each under its own checkpoint when `remat`
    (the reference's `jax.checkpoint(layer_step)` inside `group_step`)."""
    x = _shared_block_fwd(shared, x, cfg, mask=mask, positions=positions,
                          attn_impl=attn_impl)
    for blk in blocks:
        x, _ = _run(remat, _block_fwd, blk, x, cfg, mask=mask,
                    positions=positions)
    return x


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings `emb[tokens]` in the backbone's dtype."""
    return emb[tokens].to(BACKBONE)


def embed_inputs(params: LM, x: torch.Tensor, cfg: ArchConfig,
                 prefix_embeds: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, int]:
    """What `lm_hidden` does between the lookup and the blocks: `x` (B,
    S, D), the token embeddings in the backbone's dtype, with
    `prefix_embeds` (B, P, D) cast and prepended and, for learned
    positions, `pos_emb[:P + S]` added (raising past the table).
    Returns (x, P)."""
    prefix_len = 0
    if prefix_embeds is not None:
        if (prefix_embeds.dim() != 3 or prefix_embeds.shape[0] != x.shape[0]
                or prefix_embeds.shape[2] != x.shape[2]):
            raise ValueError(f"prefix_embeds must be (B, P, D) = ("
                             f"{x.shape[0]}, P, {x.shape[2]}), got "
                             f"{tuple(prefix_embeds.shape)}")
        x = torch.cat([prefix_embeds.to(device=x.device, dtype=x.dtype), x],
                      dim=1)
        prefix_len = prefix_embeds.shape[1]
    s = x.shape[1]
    if cfg.pos == "learned":
        if s > MAX_LEARNED_POS:
            raise ValueError(f"{s} positions past the learned table's "
                             f"{MAX_LEARNED_POS}")
        x = x + params.pos_emb[:s].to(x.dtype)[None]
    return x, prefix_len


def lm_hidden(params: LM, tokens: torch.Tensor, cfg: ArchConfig, *,
              mask: torch.Tensor | None = None,
              prefix_embeds: torch.Tensor | None = None,
              mlstm_chunked: bool = False, remat: bool = False,
              attn_impl: str = "dense") -> tuple[torch.Tensor, torch.Tensor]:
    """Embed -> bf16 (+ the learned positions `pos_emb[:S]`) -> blocks
    -> final norm.  Returns (hidden (B, S, D), the MoE aux loss summed
    over the layers, float32 (`router_aux`); 0 for the dense family).
    attn_impl='blockwise' never materializes (S, S) scores (32k+
    prefill).  `remat` runs each block under `torch.utils.checkpoint`
    (the reference's `jax.checkpoint(layer_step)`): backward keeps one
    (B, S, D) input a layer and recomputes the rest.  The hybrid family
    runs the shared block, then `shared_attn_every` Mamba2 layers, group
    after group (the reference's grouped scan); under `remat` a group
    runs under one checkpoint and each of its Mamba2 layers under its
    own inside it (the reference's `jax.checkpoint(group_step)`), so
    backward keeps one (B, S, D) input a group.  The SSM family runs its
    (mLSTM, sLSTM) pairs, the mLSTM chunkwise when `mlstm_chunked` (the
    prefill and the train step), else as the recurrence.

    `prefix_embeds` (B, P, D): modality-stub embeddings (the VLM's
    patches) cast to the backbone's dtype and prepended to the token
    embeddings, so S counts them; the blockwise attention then sees
    every position below P in both directions (`prefix_len`, through
    the flash attention kernels; MLA's blockwise form has no prefix, as
    in the reference).  `mask` (S, S) bool is the dense attention's
    (default causal; the VLM's loss passes `prefix_lm_mask`)."""
    hidden, stats = hidden_and_stats(
        params, tokens, cfg, mask=mask, prefix_embeds=prefix_embeds,
        mlstm_chunked=mlstm_chunked, remat=remat, attn_impl=attn_impl)
    return hidden, router_aux(cfg, stats, hidden.device)


def hidden_and_stats(params: LM, tokens: torch.Tensor, cfg: ArchConfig, *,
                     mask: torch.Tensor | None = None,
                     prefix_embeds: torch.Tensor | None = None,
                     mlstm_chunked: bool = False, remat: bool = False,
                     attn_impl: str = "dense"
                     ) -> tuple[torch.Tensor, list]:
    """`lm_hidden` with each MoE layer's `mlp.RouterStats` in a list, in
    layer order, in place of their aux loss (an empty list without an
    MoE)."""
    check_dense(cfg)
    x, prefix_len = embed_inputs(params, embed_tokens(params.emb, tokens),
                                 cfg, prefix_embeds)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    if mask is None and attn_impl == "dense":
        mask = causal_mask(s, x.device)

    if cfg.family == "hybrid":
        per = cfg.hybrid.shared_attn_every
        for g in range(0, len(params.blocks), per):
            x = _run(remat, _group_fwd, params.shared,
                     params.blocks[g:g + per], x, cfg, mask=mask,
                     positions=positions, attn_impl=attn_impl, remat=remat)
        return final_norm(params, x, cfg), []
    stats = []
    for blk in params.blocks:
        x, st = _run(remat, _block_fwd, blk, x, cfg, mask=mask,
                     positions=positions, attn_impl=attn_impl,
                     prefix_len=prefix_len, mlstm_chunked=mlstm_chunked)
        if st is not None:
            stats.append(st)
    return final_norm(params, x, cfg), stats


def router_aux(cfg: ArchConfig, stats: list,
               device: torch.device) -> torch.Tensor:
    """The MoE aux loss from each MoE layer's `mlp.RouterStats` (`stats`,
    in layer order): each layer's `mlp.aux_loss`, summed over the layers
    from 0, float32 on `device` (0 without an MoE).  A batch's own
    statistics give its aux loss; the mesh step passes those of every
    part of a microbatch, summed layer by layer, so each layer's
    load-balance term is the whole microbatch's."""
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for st in stats:
        aux = aux + mlp.aux_loss(cfg.moe, st)
    return aux


def final_norm(params: LM, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return apply_norm(params.final_norm, x, cfg.norm)


def lm_logits(params: LM, hidden: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    head = params.emb.t() if cfg.tie_embeddings else params.head
    return hidden @ head.to(hidden.dtype)


def lm_loss(params: LM, batch: dict, cfg: ArchConfig, *,
            mlstm_chunked: bool = False,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """Token-mean cross-entropy (with the z-loss) of `batch["targets"]`
    under the dense attention forward, plus the MoE aux loss: `(loss +
    aux, metrics)`, metrics `nll`, `z_loss`, `ppl_proxy` and `aux_loss`
    (0 for the dense family, which has no MoE router) as 0-dim
    tensors.  `mlstm_chunked` as `lm_hidden`'s."""
    loss, metrics, stats = lm_loss_parts(params, batch, cfg, remat=remat,
                                         mlstm_chunked=mlstm_chunked)
    aux = router_aux(cfg, stats, loss.device)
    metrics["aux_loss"] = aux
    return loss + aux, metrics


def lm_loss_parts(params: LM, batch: dict, cfg: ArchConfig, *,
                  mlstm_chunked: bool = False,
                  remat: bool = False) -> tuple[torch.Tensor, dict, list]:
    """`lm_loss` without the aux loss: (the cross-entropy with its
    z-loss, its metrics `nll`, `z_loss` and `ppl_proxy`, each MoE layer's
    `mlp.RouterStats`)."""
    hidden, stats = hidden_and_stats(params, batch["inputs"], cfg,
                                     remat=remat, mlstm_chunked=mlstm_chunked)
    logits = lm_logits(params, hidden, cfg)
    loss, metrics = softmax_cross_entropy(logits, batch["targets"])
    return loss, metrics, stats


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _init_layer_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
                      device, dtype: torch.dtype) -> dict:
    """One layer's decode cache (`init_decode_state` stacks them)."""
    if cfg.family == "hybrid":
        return mamba2.init_mamba2_state(cfg, batch, device=device)
    if cfg.family == "ssm":
        return {"mlstm": xlstm.init_mlstm_state(cfg, batch, device=device),
                "slstm": xlstm.init_slstm_state(cfg, batch, device=device)}
    init = attn.init_mla_cache if cfg.mla is not None else attn.init_kv_cache
    return init(cfg, batch, max_seq, dtype=dtype, device=device)


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int, *,
                      device=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode state: every layer's cache stacked, zeroed on `device`
    (CUDA when None, raising without it), and the next position `pos` (a
    host int, shared by the batch).  The caches are k / v (L, B, KV, S,
    Dh) each in `dtype`, or with MLA the latent `c_kv` (L, B, S, kv_lora)
    and the rope key `k_rope` (L, B, S, rope).  The hybrid family's are
    the Mamba2 states `ssm` (L, B, H, N, P) and `conv` (L, B, K - 1, D_i
    + 2 G N) in float32 (`mamba2.init_mamba2_state`'s default), and its
    `shared_caches` one k / v pair (B, KV, S, Dh) in `dtype` for each
    group's call of the shared block, stacked to (L / per, ...).  The SSM
    family's are float32 recurrent states of a size independent of
    `max_seq`, stacked over the L / 2 pairs: `mlstm` {c (B, H, dh, dh),
    n (B, H, dh), m (B, H) at -1e30, conv (B, K - 1, inner)} and `slstm`
    {c, n, m at -1e30, h}, each (B, H, D / H)."""
    check_dense(cfg)
    one = _init_layer_cache(cfg, batch, max_seq, device=device, dtype=dtype)
    state = {"caches": stack_state(one, n_stacked_layers(cfg)), "pos": 0}
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.hybrid.shared_attn_every
        sc = attn.init_kv_cache(_zamba_attn_cfg(cfg), batch, max_seq,
                                dtype=dtype, device=device)
        state["shared_caches"] = stack_state(sc, groups)
    return state


def stack_state(one: dict, n: int) -> dict:
    """One layer's decode state (a dict of tensors, or of such dicts)
    repeated on a new leading axis of `n`."""
    return {k: stack_state(v, n) if isinstance(v, dict)
            else v.new_empty((n,) + v.shape).copy_(v)
            for k, v in one.items()}


def layer_state(caches: dict, i: int) -> dict:
    """Layer `i`'s slice of a stacked decode state: views, so a write
    into them writes the stacked tensors."""
    return {k: layer_state(v, i) if isinstance(v, dict) else v[i]
            for k, v in caches.items()}


def _write(cache: dict, new: dict) -> None:
    for k, t in new.items():
        if isinstance(t, dict):
            _write(cache[k], t)
        else:
            cache[k].copy_(t)


def _cache_len(state: dict) -> int | None:
    """Positions of a decode state's stacked attention cache: (L, B, KV,
    S, Dh), MLA's (L, B, S, C), or the hybrid family's shared caches
    (L / per, B, KV, S, Dh); None for the SSM family, whose state has
    no positions."""
    caches = state.get("shared_caches", state["caches"])
    if "k" in caches:
        return caches["k"].shape[3]
    return caches["c_kv"].shape[2] if "c_kv" in caches else None


def _shared_decode(p: SharedBlock, x_t: torch.Tensor, cache: dict, pos: int,
                   cfg: ArchConfig) -> torch.Tensor:
    """The shared block's decode over one group's k / v cache (the same
    weights at every group, a different cache each call)."""
    h = apply_norm(p.ln1, x_t[:, None], cfg.norm)[:, 0]
    a, _ = attn.attention_decode(p.attn, h, cache, pos, _zamba_attn_cfg(cfg))
    x_t = x_t + a
    h = apply_norm(p.ln2, x_t[:, None], cfg.norm)[:, 0]
    return x_t + mlp.mlp_fwd(p.ffn, h, cfg)


def _layer_decode(p: Block, x_t: torch.Tensor, cache: dict, pos: int,
                  cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One layer's decode.  The hybrid family's Mamba2 state and the SSM
    family's mLSTM and sLSTM states are written back into `cache`'s
    tensors in place."""
    h = apply_norm(p.ln1, x_t[:, None], cfg.norm)[:, 0]
    if cfg.family == "hybrid":
        y, new = mamba2.mamba2_decode(p.mamba, h, cache, cfg)
        _write(cache, new)
        return x_t + y, cache
    if cfg.family == "ssm":
        y, new_m = xlstm.mlstm_decode(p.mlstm, h, cache["mlstm"], cfg)
        x_t = x_t + y
        h = apply_norm(p.ln2, x_t[:, None], cfg.norm)[:, 0]
        y, new_s = xlstm.slstm_decode(p.slstm, h, cache["slstm"], cfg)
        _write(cache, {"mlstm": new_m, "slstm": new_s})
        return x_t + y, cache
    if cfg.mla is not None:
        a, cache = attn.mla_decode(p.attn, h, cache, pos, cfg)
    else:
        a, cache = attn.attention_decode(p.attn, h, cache, pos, cfg)
    x_t = x_t + a
    h = apply_norm(p.ln2, x_t[:, None], cfg.norm)[:, 0]
    if cfg.moe is not None:        # the batch's B tokens are one group
        y = mlp.moe_fwd(p.ffn, h[:, None], cfg)[0][:, 0]
    else:
        y = mlp.mlp_fwd(p.ffn, h, cfg)
    return x_t + y, cache


def check_position(state: dict, cfg: ArchConfig) -> None:
    """Raise `ValueError` where `state["pos"]` lies outside the state's
    cache (no bound for the SSM family's recurrent state) or, with
    learned positions, past the table's `MAX_LEARNED_POS` rows (the
    reference clamps both)."""
    pos, n = state["pos"], _cache_len(state)
    if pos < 0 or (n is not None and pos >= n):
        raise ValueError(f"decode position {pos} is outside the cache's "
                         f"{n} positions")
    if cfg.pos == "learned" and pos >= MAX_LEARNED_POS:
        raise ValueError(f"decode position {pos} is past the learned "
                         f"table's {MAX_LEARNED_POS} positions")


@torch.no_grad()
def decode_step(params: LM, state: dict, tokens: torch.Tensor,
                cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B,) -> (logits (B, V) float32, new state).

    The embedding goes to bf16 (`BACKBONE`), as in the reference, plus
    the learned position `pos_emb[pos]` where the config has one; a
    Python loop over the layers writes each layer's k / v (MLA: latent
    and rope key; the hybrid family: its Mamba2 state, and the shared
    block's k / v at each group's start; the SSM family: its mLSTM and
    sLSTM states) into the stacked caches in place at `state["pos"]`,
    so the new state holds the same cache tensors.  Where the reference
    clamps a write past the cache's end, this raises, and so does a
    position past the learned table."""
    check_dense(cfg)
    pos = state["pos"]
    check_position(state, cfg)
    x = params.emb[tokens].to(BACKBONE)
    if cfg.pos == "learned":
        x = x + params.pos_emb[pos].to(x.dtype)[None]
    for i, blk in enumerate(params.blocks):
        if cfg.family == "hybrid" and i % cfg.hybrid.shared_attn_every == 0:
            g = i // cfg.hybrid.shared_attn_every
            x = _shared_decode(params.shared, x, layer_state(
                state["shared_caches"], g), pos, cfg)
        x, _ = _layer_decode(blk, x, layer_state(state["caches"], i), pos,
                             cfg)
    x = apply_norm(params.final_norm, x[:, None], cfg.norm)[:, 0]
    return lm_logits(params, x, cfg).to(torch.float32), \
        dict(state, pos=pos + 1)
