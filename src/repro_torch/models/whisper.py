"""Whisper-style encoder-decoder backbone (audio family).

Counterpart of `repro.models.whisper`.  As in the reference, the conv
frontend is a stub: the batch carries precomputed frame embeddings (B,
F, d_model).  Everything downstream is real: the encoder's non-causal
self-attention layers over the frames with sinusoidal positions, the
decoder's causal self-attention layers with learned positions
(`pos_emb`, `MAX_LEARNED_POS` rows) and cross-attention over the
encoder's output, LayerNorm, plain GELU MLPs, MHA, the output head tied
to the token embedding (arXiv:2212.04356).

State-dict names follow the reference's pytree (`enc_blocks.<i>.attn.wq`,
`enc_norm.scale`, `emb`, `pos_emb`, `dec_blocks.<i>.xattn.wk`,
`dec_norm.bias`, ...), its stacked layer axes unrolled into
`ModuleList`s.  The decoder's self-attention runs dense or, in the
prefill (`attn_impl="blockwise"`), through `kernels/flash_attention` (on
the card `flash_attention_wgmma` at head dims (64, 64) for
whisper-large-v3).  The encoder's self-attention and the
cross-attention are dense einsums, as in the reference, where they are
jnp outside any Pallas kernel.

The reference casts the backbone to bf16 (`jnp.bfloat16`) in `encode`,
`decode_fwd`, the decode step, the decode state's cross K / V and
`precompute_cross`; here that dtype is `BACKBONE`, read at each call, so
a float32 backbone can be set to hold the arithmetic tightly.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import lm, mlp
from repro_torch.models.common import (MAX_LEARNED_POS, apply_norm,
                                       causal_mask, dense_init, embed_init,
                                       init_norm, sinusoidal_positions,
                                       softmax_cross_entropy)

BACKBONE = torch.bfloat16


def check_audio(cfg: ArchConfig) -> None:
    """Raise `ValueError` unless `cfg` is an audio-family config with its
    `encdec` sub-config."""
    if cfg.family != "audio" or cfg.encdec is None:
        raise ValueError(f"{cfg.name!r} ({cfg.family}, encdec="
                         f"{cfg.encdec}) is no audio-family config with an "
                         f"encdec sub-config")


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------
class CrossAttention(nn.Module):
    """`wq`, `wk`, `wv` (D, H*Dh) and `wo` (H*Dh, D), no biases."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
        self.wq = nn.Parameter(dense_init(generator, (d, h * dh)))
        self.wk = nn.Parameter(dense_init(generator, (d, h * dh)))
        self.wv = nn.Parameter(dense_init(generator, (d, h * dh)))
        self.wo = nn.Parameter(dense_init(generator, (h * dh, d)))


def init_cross_attention(cfg: ArchConfig,
                         generator: torch.Generator) -> CrossAttention:
    return CrossAttention(cfg, generator)


def cross_kv(p: CrossAttention, enc: torch.Tensor, cfg: ArchConfig):
    """The encoder output's keys and values, (B, F, H, Dh) each; H is
    the weights' (a tensor-parallel position's own heads, or all)."""
    b, f, _ = enc.shape
    dh = cfg.resolved_head_dim
    h = p.wk.shape[1] // dh
    k = (enc @ p.wk.to(enc.dtype)).reshape(b, f, h, dh)
    v = (enc @ p.wv.to(enc.dtype)).reshape(b, f, h, dh)
    return k, v


def cross_attention_fwd(p: CrossAttention, x: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x (B, S, D) attends over every frame of k / v (B, F, H, Dh).  The
    scores leave the einsum in x's dtype and are scaled in float32 (the
    reference divides by a NumPy scalar, which promotes); softmax in
    float32, its probabilities back to x's dtype for P.V.  The heads are
    the weights': on a tensor-parallel position's the result is its
    partial sum of the output projection."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    h = p.wq.shape[1] // dh
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, h, dh)
    scores = torch.einsum("bshd,bfhd->bhsf", q, k).float() / float(
        np.float32(np.sqrt(dh)))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhsf,bfhd->bshd", probs, v).reshape(b, s, h * dh)
    return out @ p.wo.to(x.dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
class EncBlock(nn.Module):
    """`ln1`, `attn` (non-causal self-attention), `ln2`, `ffn`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.ln1 = init_norm(d, cfg.norm)
        self.attn = attn.init_attention(cfg, generator)
        self.ln2 = init_norm(d, cfg.norm)
        self.ffn = mlp.init_mlp(d, cfg.d_ff, cfg, generator)


class DecBlock(nn.Module):
    """`ln1`, `attn` (causal self-attention), `lnx`, `xattn`
    (cross-attention), `ln2`, `ffn`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.ln1 = init_norm(d, cfg.norm)
        self.attn = attn.init_attention(cfg, generator)
        self.lnx = init_norm(d, cfg.norm)
        self.xattn = init_cross_attention(cfg, generator)
        self.ln2 = init_norm(d, cfg.norm)
        self.ffn = mlp.init_mlp(d, cfg.d_ff, cfg, generator)


class Whisper(nn.Module):
    """Parameters drawn from `generator` in a fixed order (the encoder's
    layers, `enc_norm`, `emb`, `pos_emb` (MAX_LEARNED_POS, D), the
    decoder's layers, `dec_norm`), each part moved to `device` (default:
    the CPU) and cast as `lm._serving` says (stacked rank >= 2 to
    `dtype`) right after it is drawn, as `lm.LM` does."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 device: torch.device | None = None,
                 dtype: torch.dtype | None = None, place=None):
        super().__init__()
        check_audio(cfg)
        dev = torch.device("cpu" if device is None else device)
        d = cfg.d_model
        self.enc_blocks = nn.ModuleList(
            lm._place(EncBlock(cfg, generator), f"enc_blocks.{i}.", dev,
                      dtype, place)
            for i in range(cfg.encdec.n_enc_layers))
        self.enc_norm = lm._place(init_norm(d, cfg.norm), "enc_norm.", dev,
                                  dtype, place)
        self.emb = lm._leaf("emb", embed_init(generator, (cfg.vocab, d)),
                            dev, dtype, place)
        self.pos_emb = lm._leaf("pos_emb", embed_init(
            generator, (MAX_LEARNED_POS, d)), dev, dtype, place)
        self.dec_blocks = nn.ModuleList(
            lm._place(DecBlock(cfg, generator), f"dec_blocks.{i}.", dev,
                      dtype, place)
            for i in range(cfg.n_layers))
        self.dec_norm = lm._place(init_norm(d, cfg.norm), "dec_norm.", dev,
                                  dtype, place)


def init_whisper(cfg: ArchConfig, *, seed: int = 0, device=None,
                 dtype: torch.dtype | None = None, draw_on=None,
                 place=None) -> Whisper:
    """Parameters from a `torch.Generator` seeded with `seed` (the CPU's,
    or `draw_on`'s), on `device` (CUDA when None, raising without it);
    `dtype=torch.bfloat16` gives the serving weights, `place` each leaf
    to its taker, as `lm.init_lm`."""
    dev = resolve_device(device)
    g = torch.Generator(device="cpu" if draw_on is None else draw_on)
    return Whisper(cfg, g.manual_seed(seed), device=dev, dtype=dtype,
                   place=place)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _enc_block_fwd(p: EncBlock, x: torch.Tensor, cfg: ArchConfig, *,
                   mask: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    h = apply_norm(p.ln1, x, cfg.norm)
    x = x + attn.attention_fwd(p.attn, h, cfg, mask=mask,
                               positions=positions)
    h = apply_norm(p.ln2, x, cfg.norm)
    return x + mlp.mlp_fwd(p.ffn, h, cfg)


def encode(params: Whisper, frames: torch.Tensor, cfg: ArchConfig, *,
           remat: bool = False) -> torch.Tensor:
    """frames (B, F, D) stub embeddings -> the encoder's output (B, F, D)
    in `BACKBONE`: the frames and the sinusoidal positions each cast to
    it and summed, every frame attending to every frame.  `remat` runs
    each layer under `torch.utils.checkpoint`."""
    b, f, d = frames.shape
    x = frames.to(BACKBONE) + sinusoidal_positions(
        f, d, frames.device).to(BACKBONE)[None]
    full = torch.ones((f, f), dtype=torch.bool, device=frames.device)
    positions = torch.arange(f, device=frames.device)
    for blk in params.enc_blocks:
        x = lm._run(remat, _enc_block_fwd, blk, x, cfg, mask=full,
                    positions=positions)
    return apply_norm(params.enc_norm, x, cfg.norm)


def _dec_block_fwd(p: DecBlock, x: torch.Tensor, enc: torch.Tensor,
                   cfg: ArchConfig, *, mask: torch.Tensor | None,
                   positions: torch.Tensor, attn_impl: str) -> torch.Tensor:
    h = apply_norm(p.ln1, x, cfg.norm)
    if attn_impl == "blockwise":
        a = attn.attention_fwd_blockwise(p.attn, h, cfg, positions=positions)
    else:
        a = attn.attention_fwd(p.attn, h, cfg, mask=mask,
                               positions=positions)
    x = x + a
    h = apply_norm(p.lnx, x, cfg.norm)
    k, v = cross_kv(p.xattn, enc, cfg)
    x = x + cross_attention_fwd(p.xattn, h, k, v, cfg)
    h = apply_norm(p.ln2, x, cfg.norm)
    return x + mlp.mlp_fwd(p.ffn, h, cfg)


def decode_fwd(params: Whisper, tokens: torch.Tensor, enc: torch.Tensor,
               cfg: ArchConfig, *, remat: bool = False,
               attn_impl: str = "dense") -> torch.Tensor:
    """Teacher-forced decoder forward over `enc` (B, F, D): logits (B, S,
    V) in `BACKBONE`.  attn_impl 'dense' (causal mask) or 'blockwise'
    (the flash attention kernels; the prefill's); S may not pass the
    learned table's `MAX_LEARNED_POS` positions (the reference clamps)."""
    if attn_impl not in ("dense", "blockwise"):
        raise ValueError(f"attn_impl must be 'dense' or 'blockwise', not "
                         f"{attn_impl!r}")
    s = tokens.shape[1]
    if s > MAX_LEARNED_POS:
        raise ValueError(f"{s} positions past the learned table's "
                         f"{MAX_LEARNED_POS}")
    x = params.emb[tokens].to(BACKBONE)
    x = x + params.pos_emb[:s].to(x.dtype)[None]
    mask = causal_mask(s, x.device) if attn_impl == "dense" else None
    positions = torch.arange(s, device=x.device)
    for blk in params.dec_blocks:
        x = lm._run(remat, _dec_block_fwd, blk, x, enc, cfg, mask=mask,
                    positions=positions, attn_impl=attn_impl)
    x = apply_norm(params.dec_norm, x, cfg.norm)
    return x @ params.emb.t().to(x.dtype)       # the head is tied to emb


def whisper_loss(params: Whisper, batch: dict, cfg: ArchConfig, *,
                 remat: bool = False) -> tuple[torch.Tensor, dict]:
    """batch: frames (B, F, D) float, inputs (B, S) int, targets (B, S).
    Token-mean cross-entropy (with the z-loss) of the dense decoder over
    the encoded frames: (loss, metrics) with `aux_loss` 0, as
    `lm.lm_loss` returns them."""
    enc = encode(params, batch["frames"], cfg, remat=remat)
    logits = decode_fwd(params, batch["inputs"], enc, cfg, remat=remat)
    loss, metrics = softmax_cross_entropy(logits, batch["targets"])
    metrics["aux_loss"] = torch.zeros((), dtype=torch.float32,
                                      device=loss.device)
    return loss, metrics


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------
def init_whisper_decode_state(cfg: ArchConfig, batch: int, max_seq: int, *,
                              device=None,
                              dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode state on `device` (CUDA when None, raising without it):
    the decoder's self-attention caches k / v (L, B, H, S, Dh) in `dtype`,
    the cross-attention's `cross_k` / `cross_v` (L, B, F, H, Dh) zeroed in
    `BACKBONE` (the reference's engine serves with them zero;
    `precompute_cross` gives the encoded frames'), and `pos` (a host
    int)."""
    check_audio(cfg)
    dev = resolve_device(device)
    one = attn.init_kv_cache(cfg, batch, max_seq, dtype=dtype, device=dev)
    cross = (cfg.n_layers, batch, cfg.encdec.enc_frames, cfg.n_heads,
             cfg.resolved_head_dim)
    return {"caches": lm.stack_state(one, cfg.n_layers),
            "cross_k": torch.zeros(cross, dtype=BACKBONE, device=dev),
            "cross_v": torch.zeros(cross, dtype=BACKBONE, device=dev),
            "pos": 0}


@torch.no_grad()
def precompute_cross(params: Whisper, frames: torch.Tensor,
                     cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the encoder once and give every decoder layer's cross K / V,
    (L, B, F, H, Dh) each in `BACKBONE`, for the decode state's
    `cross_k` / `cross_v`."""
    enc = encode(params, frames, cfg)
    kv = [cross_kv(blk.xattn, enc, cfg) for blk in params.dec_blocks]
    return (torch.stack([k.to(BACKBONE) for k, _ in kv]),
            torch.stack([v.to(BACKBONE) for _, v in kv]))


@torch.no_grad()
def whisper_decode_step(params: Whisper, state: dict, tokens: torch.Tensor,
                        cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B,) -> (logits (B, V) float32, new state).
    Each layer writes its k / v into the self-attention cache in place at
    `state["pos"]` and attends over its `cross_k` / `cross_v`.  A
    position outside the cache or past the learned table raises, where
    the reference clamps."""
    check_audio(cfg)
    pos = state["pos"]
    lm.check_position(state, cfg)
    x = params.emb[tokens].to(BACKBONE)
    x = x + params.pos_emb[pos].to(x.dtype)[None]
    for i, blk in enumerate(params.dec_blocks):
        h = apply_norm(blk.ln1, x[:, None], cfg.norm)[:, 0]
        a, _ = attn.attention_decode(blk.attn, h, lm.layer_state(
            state["caches"], i), pos, cfg)
        x = x + a
        h = apply_norm(blk.lnx, x[:, None], cfg.norm)
        x = x + cross_attention_fwd(
            blk.xattn, h, state["cross_k"][i].to(h.dtype),
            state["cross_v"][i].to(h.dtype), cfg)[:, 0]
        h = apply_norm(blk.ln2, x[:, None], cfg.norm)[:, 0]
        x = x + mlp.mlp_fwd(blk.ffn, h, cfg)
    x = apply_norm(params.dec_norm, x[:, None], cfg.norm)[:, 0]
    logits = x @ params.emb.t().to(x.dtype)
    return logits.to(torch.float32), dict(state, pos=pos + 1)
