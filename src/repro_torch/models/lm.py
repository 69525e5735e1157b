"""Decoder-only LM assembled from an ArchConfig: the dense family and
the MoE family (deepseek-v2-lite with MLA, arctic with GQA).

Counterpart of the dense and MoE families of `repro.models.lm`:
`init_lm` builds the parameters as `nn.Module`s whose state-dict names
follow the reference's pytree (`emb`, `blocks.<i>.ln1.scale`,
`blocks.<i>.attn.wq`, `blocks.<i>.ffn.router`, ..., `final_norm.scale`,
`head`), with the reference's stacked `blocks` axis unrolled into a
`ModuleList`.  MoE layers add their router aux loss, which `lm_hidden`
sums over the layers and `lm_loss` adds to the loss.  `lm_hidden` / `lm_logits`
are the forward of prefill (`repro_torch.launch.steps`), dense or
blockwise, and `lm_loss` the training loss (`launch.steps
.make_train_step`); `init_decode_state` / `decode_step` the one-token
decode of serving (`repro_torch.serve.engine`); the CIM-in-the-loop
trainer has its own forward (`repro_torch.train.acim_lm`).
`stacked_ndim` gives a parameter the rank of the reference's stacked
leaf, which its dtype and weight-decay rules read.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp
from repro_torch.models.common import (apply_norm, causal_mask, dense_init,
                                       embed_init, init_norm,
                                       softmax_cross_entropy)


# Where each family the port does not build stands in ROADMAP queue 1.
_NOT_PORTED = {"vlm": "item 6.4 (paligemma)",
               "hybrid": "item 6.5 (mamba2, zamba2)",
               "ssm": "item 6.6 (xlstm)", "audio": "item 6.6 (whisper)"}


def check_dense(cfg: ArchConfig) -> None:
    """Raise unless the port builds `cfg`: the dense decoder and the MoE
    family, each with GQA or MLA attention, with RoPE (no learned
    positions).  The message names the ROADMAP item that brings what is
    missing."""
    if cfg.family not in ("dense", "moe"):
        item = _NOT_PORTED.get(cfg.family, "item 6")
        raise NotImplementedError(
            f"the port builds the dense and MoE families only, not "
            f"{cfg.name!r} ({cfg.family}): ROADMAP queue 1 {item}")
    if cfg.pos == "learned":
        raise NotImplementedError(
            f"learned positions ({cfg.name!r}) are not ported: ROADMAP "
            f"queue 1 item 6.7")


class Block(nn.Module):
    """One attention + FFN layer (the reference's `_init_block`): `ln1`,
    `attn` (MLA where the config has it), `ln2`, `ffn` (an MoE where the
    config has one)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.ln1 = init_norm(d, cfg.norm)
        self.attn = (attn.init_mla(cfg, generator) if cfg.mla is not None
                     else attn.init_attention(cfg, generator))
        self.ln2 = init_norm(d, cfg.norm)
        self.ffn = (mlp.init_moe(d, cfg, generator) if cfg.moe is not None
                    else mlp.init_mlp(d, cfg.d_ff, cfg, generator))


def stacked_ndim(name: str, t: torch.Tensor) -> int:
    """The rank the reference gives parameter `name` (a state-dict name
    of `LM`).  The reference stacks every layer's leaves on a leading
    n_layers axis (`blocks.attn.wq` is (L, D, H*Dh)), so a tensor under
    `blocks.<i>.` counts its own rank plus one: `blocks.<i>.ln1.scale`
    has rank 2 there, `final_norm.scale` rank 1.  The reference's rules
    that test `ndim >= 2` read this rank: the serving cast
    (`_to_serving_dtype`), AdamW's weight decay and the train step's
    `cast_bf16`."""
    return t.dim() + (1 if name.startswith("blocks.") else 0)


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
           dtype: torch.dtype | None) -> nn.Module:
    for name, prm in module.named_parameters():
        prm.data = _serving(prefix + name, prm.data, device, dtype)
    return module


class LM(nn.Module):
    """Parameters drawn from `generator` in a fixed order (embedding,
    layer 0, ..., layer L-1, final norm, head), on the generator's
    device.  Each part is moved to `device` (default: the CPU) and cast
    as `_serving` says right after it is drawn, so the drawing device
    holds one layer in float32 at a time."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device: torch.device | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        check_dense(cfg)
        dev = torch.device("cpu" if device is None else device)
        self.emb = nn.Parameter(_serving("emb", embed_init(
            generator, (cfg.vocab, cfg.d_model)), dev, dtype))
        self.blocks = nn.ModuleList(
            _place(Block(cfg, generator), f"blocks.{i}.", dev, dtype)
            for i in range(cfg.n_layers))
        self.final_norm = _place(init_norm(cfg.d_model, cfg.norm),
                                 "final_norm.", dev, dtype)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(_serving("head", dense_init(
                generator, (cfg.d_model, cfg.vocab)), dev, dtype))


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None,
            dtype: torch.dtype | None = None, draw_on=None) -> LM:
    """Parameters from a `torch.Generator` seeded with `seed`, on
    `device` (CUDA when None, raising without it).  `dtype=torch.bfloat16`
    gives the serving weights.

    By default the generator is the CPU's, so one seed gives the same
    weights on every device: qwen2.5-3b's 3.4 G truncated normals take
    about half a minute on an 8-core host with PyTorch 2.11, and each
    layer is moved as it is drawn.  `draw_on` names another device to
    draw on (a generator of that device, seeded with `seed`): on the
    card, deepseek-v2-lite's 16.2 G draw in seconds, but the weights
    are not the CPU draw's."""
    dev = resolve_device(device)
    g = torch.Generator(device="cpu" if draw_on is None else draw_on)
    return LM(cfg, g.manual_seed(seed), device=dev, dtype=dtype)


def _block_fwd(p: Block, x: torch.Tensor, cfg: ArchConfig, *,
               mask: torch.Tensor | None, positions: torch.Tensor,
               attn_impl: str = "dense",
               prefix_len: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer: (y, the MoE aux loss, float32, 0 without an MoE).
    attn_impl: 'dense' | 'blockwise' (32k+ seqs)."""
    if attn_impl not in ("dense", "blockwise"):
        raise ValueError(f"attn_impl must be 'dense' or 'blockwise', not "
                         f"{attn_impl!r}")
    h = apply_norm(p.ln1, x, cfg.norm)
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
        y, aux = mlp.moe_fwd(p.ffn, h, cfg)
    else:
        y = mlp.mlp_fwd(p.ffn, h, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def lm_hidden(params: LM, tokens: torch.Tensor, cfg: ArchConfig, *,
              prefix_embeds: torch.Tensor | None = None,
              remat: bool = False,
              attn_impl: str = "dense") -> tuple[torch.Tensor, torch.Tensor]:
    """Embed -> bf16 -> blocks -> final norm.  Returns (hidden (B, S, D),
    the MoE aux loss summed over the layers, float32; 0 for the dense
    family).  attn_impl='blockwise' never materializes (S, S) scores
    (32k+ prefill).  `remat` runs each block under
    `torch.utils.checkpoint` (the reference's `jax.checkpoint
    (layer_step)`): backward keeps one (B, S, D) input a layer and
    recomputes the rest."""
    check_dense(cfg)
    if prefix_embeds is not None:
        raise NotImplementedError("prefix embeddings (the VLM prefix) are "
                                  "not ported")
    x = params.emb[tokens].to(torch.bfloat16)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    mask = causal_mask(s, x.device) if attn_impl == "dense" else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.blocks:
        if remat:
            x, a = checkpoint(_block_fwd, blk, x, cfg, mask=mask,
                              positions=positions, attn_impl=attn_impl,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _block_fwd(blk, x, cfg, mask=mask, positions=positions,
                              attn_impl=attn_impl)
        aux = aux + a
    return apply_norm(params.final_norm, x, cfg.norm), aux


def lm_logits(params: LM, hidden: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    head = params.emb.t() if cfg.tie_embeddings else params.head
    return hidden @ head.to(hidden.dtype)


def lm_loss(params: LM, batch: dict, cfg: ArchConfig, *,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """Token-mean cross-entropy (with the z-loss) of `batch["targets"]`
    under the dense attention forward, plus the MoE aux loss: `(loss +
    aux, metrics)`, metrics `nll`, `z_loss`, `ppl_proxy` and `aux_loss`
    (0 for the dense family, which has no MoE router) as 0-dim
    tensors."""
    hidden, aux = lm_hidden(params, batch["inputs"], cfg, remat=remat)
    logits = lm_logits(params, hidden, cfg)
    loss, metrics = softmax_cross_entropy(logits, batch["targets"])
    metrics["aux_loss"] = aux
    return loss + aux, metrics


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int, *,
                      device=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode state: every layer's cache stacked, zeroed on `device`
    (CUDA when None, raising without it), and the next position `pos` (a
    host int, shared by the batch).  The caches are k / v (L, B, KV, S,
    Dh) each, or with MLA the latent `c_kv` (L, B, S, kv_lora) and the
    rope key `k_rope` (L, B, S, rope)."""
    check_dense(cfg)
    init = attn.init_mla_cache if cfg.mla is not None else attn.init_kv_cache
    one = init(cfg, batch, max_seq, dtype=dtype, device=device)
    caches = {k: v.new_zeros((cfg.n_layers,) + v.shape)
              for k, v in one.items()}
    return {"caches": caches, "pos": 0}


def _cache_len(caches: dict) -> int:
    """Positions of a stacked decode cache: (L, B, KV, S, Dh) or MLA's
    (L, B, S, C)."""
    return caches["k"].shape[3] if "k" in caches else caches["c_kv"].shape[2]


def _layer_decode(p: Block, x_t: torch.Tensor, cache: dict, pos: int,
                  cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    h = apply_norm(p.ln1, x_t[:, None], cfg.norm)[:, 0]
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


@torch.no_grad()
def decode_step(params: LM, state: dict, tokens: torch.Tensor,
                cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B,) -> (logits (B, V) float32, new state).

    The embedding goes to bf16, as in the reference; a Python loop over
    the layers writes each layer's k / v (MLA: latent and rope key) into
    the stacked cache in place at `state["pos"]`, so the new state holds
    the same cache tensors.  Where the reference clamps a write past the
    cache's end, this raises."""
    check_dense(cfg)
    pos = state["pos"]
    caches = state["caches"]
    if not 0 <= pos < _cache_len(caches):
        raise ValueError(f"decode position {pos} is outside the cache's "
                         f"{_cache_len(caches)} positions")
    x = params.emb[tokens].to(torch.bfloat16)
    for i, blk in enumerate(params.blocks):
        x, _ = _layer_decode(blk, x, {k: c[i] for k, c in caches.items()},
                             pos, cfg)
    x = apply_norm(params.final_norm, x[:, None], cfg.norm)[:, 0]
    return lm_logits(params, x, cfg).to(torch.float32), \
        {"caches": caches, "pos": pos + 1}
