"""Dense decoder-only LM assembled from an ArchConfig.

Counterpart of the dense family of `repro.models.lm`: `init_lm` builds
the parameters as `nn.Module`s whose state-dict names follow the
reference's pytree (`emb`, `blocks.<i>.ln1.scale`, `blocks.<i>.attn.wq`,
..., `final_norm.scale`, `head`), with the reference's stacked
`blocks` axis unrolled into a `ModuleList`.  `lm_hidden` / `lm_logits`
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
_NOT_PORTED = {"moe": "item 6.3 (MoE, MLA)", "vlm": "item 6.4 (paligemma)",
               "hybrid": "item 6.5 (mamba2, zamba2)",
               "ssm": "item 6.6 (xlstm)", "audio": "item 6.6 (whisper)"}


def check_dense(cfg: ArchConfig) -> None:
    """Raise unless the port builds `cfg`: the dense family without MoE,
    MLA or learned positions.  The message names the ROADMAP item that
    brings what is missing."""
    if cfg.family != "dense" or cfg.mla is not None or cfg.moe is not None:
        item = _NOT_PORTED.get(cfg.family, _NOT_PORTED["moe"])
        raise NotImplementedError(
            f"the port builds the dense family only (no MoE, no MLA), not "
            f"{cfg.name!r} ({cfg.family}): ROADMAP queue 1 {item}")
    if cfg.pos == "learned":
        raise NotImplementedError(
            f"learned positions ({cfg.name!r}) are not ported: ROADMAP "
            f"queue 1 item 6.7")


class Block(nn.Module):
    """One attention + FFN layer (the reference's `_init_block`): `ln1`,
    `attn`, `ln2`, `ffn`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.ln1 = init_norm(d, cfg.norm)
        self.attn = attn.init_attention(cfg, generator)
        self.ln2 = init_norm(d, cfg.norm)
        self.ffn = mlp.init_mlp(d, cfg.d_ff, cfg, generator)


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
    its stacked tree: every layer's matrices, norm scales and biases go
    to bf16; `final_norm.scale` stays float32)."""
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
    """Parameters drawn from the CPU `generator` in a fixed order
    (embedding, layer 0, ..., layer L-1, final norm, head).  Each part is
    moved to `device` (default: the CPU) and cast as `_serving` says
    right after it is drawn, so host memory holds one layer at a time."""

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
            dtype: torch.dtype | None = None) -> LM:
    """Parameters from a CPU `torch.Generator` seeded with `seed`, on
    `device` (CUDA when None, raising without it): one seed gives the
    same weights on every device.  `dtype=torch.bfloat16` gives the
    serving weights.  The draws stay on the CPU at full width too:
    qwen2.5-3b's 3.4 G truncated normals take about half a minute on an
    8-core host with PyTorch 2.11, and each layer is moved as it is
    drawn."""
    g = torch.Generator().manual_seed(seed)
    return LM(cfg, g, device=resolve_device(device), dtype=dtype)


def _block_fwd(p: Block, x: torch.Tensor, cfg: ArchConfig, *,
               mask: torch.Tensor | None, positions: torch.Tensor,
               attn_impl: str = "dense", prefix_len: int = 0) -> torch.Tensor:
    """One dense layer.  attn_impl: 'dense' | 'blockwise' (32k+ seqs).
    (The reference also returns the MoE aux loss, 0 for dense layers.)"""
    h = apply_norm(p.ln1, x, cfg.norm)
    if attn_impl == "blockwise":
        a = attn.attention_fwd_blockwise(p.attn, h, cfg, positions=positions,
                                         prefix_len=prefix_len)
    elif attn_impl == "dense":
        a = attn.attention_fwd(p.attn, h, cfg, mask=mask, positions=positions)
    else:
        raise ValueError(f"attn_impl must be 'dense' or 'blockwise', not "
                         f"{attn_impl!r}")
    x = x + a
    h = apply_norm(p.ln2, x, cfg.norm)
    return x + mlp.mlp_fwd(p.ffn, h, cfg)


def lm_hidden(params: LM, tokens: torch.Tensor, cfg: ArchConfig, *,
              prefix_embeds: torch.Tensor | None = None,
              remat: bool = False, attn_impl: str = "dense") -> torch.Tensor:
    """Embed -> bf16 -> blocks -> final norm.  Returns hidden (B, S, D)
    (the reference also returns the aux loss, 0 for the dense family).
    attn_impl='blockwise' never materializes (S, S) scores (32k+
    prefill).  `remat` runs each block under `torch.utils.checkpoint`
    (the reference's `jax.checkpoint(layer_step)`): backward keeps one
    (B, S, D) input a layer and recomputes the rest."""
    check_dense(cfg)
    if prefix_embeds is not None:
        raise NotImplementedError("prefix embeddings (the VLM prefix) are "
                                  "not ported")
    x = params.emb[tokens].to(torch.bfloat16)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    mask = causal_mask(s, x.device) if attn_impl == "dense" else None
    for blk in params.blocks:
        if remat:
            x = checkpoint(_block_fwd, blk, x, cfg, mask=mask,
                           positions=positions, attn_impl=attn_impl,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block_fwd(blk, x, cfg, mask=mask, positions=positions,
                           attn_impl=attn_impl)
    return apply_norm(params.final_norm, x, cfg.norm)


def lm_logits(params: LM, hidden: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    head = params.emb.t() if cfg.tie_embeddings else params.head
    return hidden @ head.to(hidden.dtype)


def lm_loss(params: LM, batch: dict, cfg: ArchConfig, *,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """Token-mean cross-entropy (with the z-loss) of `batch["targets"]`
    under the dense attention forward: `(loss + aux, metrics)`, metrics
    `nll`, `z_loss`, `ppl_proxy` and `aux_loss` (0 for the dense family,
    which has no MoE router) as 0-dim tensors."""
    hidden = lm_hidden(params, batch["inputs"], cfg, remat=remat)
    logits = lm_logits(params, hidden, cfg)
    loss, metrics = softmax_cross_entropy(logits, batch["targets"])
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    metrics["aux_loss"] = aux
    return loss + aux, metrics


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int, *,
                      device=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode state: every layer's k / v cache stacked, (L, B, KV, S,
    Dh) each, zeroed on `device` (CUDA when None, raising without it),
    and the next position `pos` (a host int, shared by the batch)."""
    check_dense(cfg)
    one = attn.init_kv_cache(cfg, batch, max_seq, dtype=dtype,
                             device=device)
    caches = {k: v.new_zeros((cfg.n_layers,) + v.shape)
              for k, v in one.items()}
    return {"caches": caches, "pos": 0}


def _layer_decode(p: Block, x_t: torch.Tensor, cache: dict, pos: int,
                  cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    h = apply_norm(p.ln1, x_t[:, None], cfg.norm)[:, 0]
    a, cache = attn.attention_decode(p.attn, h, cache, pos, cfg)
    x_t = x_t + a
    h = apply_norm(p.ln2, x_t[:, None], cfg.norm)[:, 0]
    return x_t + mlp.mlp_fwd(p.ffn, h, cfg), cache


@torch.no_grad()
def decode_step(params: LM, state: dict, tokens: torch.Tensor,
                cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B,) -> (logits (B, V) float32, new state).

    The embedding goes to bf16, as in the reference; a Python loop over
    the layers writes each layer's k / v into the stacked cache in place
    at `state["pos"]`, so the new state holds the same cache tensors.
    Where the reference clamps a write past the cache's end, this
    raises."""
    check_dense(cfg)
    pos = state["pos"]
    caches = state["caches"]
    if not 0 <= pos < caches["k"].shape[3]:
        raise ValueError(f"decode position {pos} is outside the cache's "
                         f"{caches['k'].shape[3]} positions")
    x = params.emb[tokens].to(torch.bfloat16)
    for i, blk in enumerate(params.blocks):
        x, _ = _layer_decode(blk, x, {"k": caches["k"][i],
                                      "v": caches["v"][i]}, pos, cfg)
    x = apply_norm(params.final_norm, x[:, None], cfg.norm)[:, 0]
    return lm_logits(params, x, cfg).to(torch.float32), \
        {"caches": caches, "pos": pos + 1}
