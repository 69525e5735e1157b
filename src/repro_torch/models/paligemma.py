"""PaliGemma-style VLM backbone (vlm family).

Counterpart of `repro.models.paligemma`.  As in the reference, the
SigLIP vision tower is a stub: the batch carries precomputed patch
embeddings (B, 256, d_model).  The language decoder is a Gemma-style
transformer (MQA kv=1, GeGLU d_ff=16384, head_dim 256, RoPE) that
attends with a *prefix-LM* mask: bidirectional across the image
patches, causal over text (arXiv:2407.07726).  The parameters are the
LM's (`lm.init_lm`, tied embeddings, no `head`).

The loss runs dense attention under `prefix_lm_mask`; the prefill
(`launch.steps.make_prefill_step`) runs the blockwise attention with
`prefix_len` = the patch count, which on the card is
`flash_attention_wgmma` at head dims (256, 256).  Decode reuses the
generic `lm.decode_step`: past the prefix everything is ordinary causal
decoding over the joint cache, and the reference has no prefix-aware
decode either.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.common import prefix_lm_mask, softmax_cross_entropy


def init_paligemma(cfg: ArchConfig, *, seed: int = 0, device=None,
                   dtype: torch.dtype | None = None, draw_on=None,
                   place=None) -> lm.LM:
    """`lm.init_lm` of the VLM's decoder (CUDA when `device` is None,
    raising without it)."""
    return lm.init_lm(cfg, seed=seed, device=device, dtype=dtype,
                      draw_on=draw_on, place=place)


def paligemma_loss(params: lm.LM, batch: dict, cfg: ArchConfig, *,
                   remat: bool = False) -> tuple[torch.Tensor, dict]:
    """batch: patches (B, P, D) float, inputs (B, S) int, targets (B, S).

    The patches are prepended to the embedded inputs and the decoder runs
    dense attention under `prefix_lm_mask(P + S, P)`; the cross-entropy
    (with the z-loss) covers the S text positions only.  Returns (loss +
    aux, metrics) as `lm.lm_loss` does."""
    patches = batch["patches"]
    p = patches.shape[1]
    s = batch["inputs"].shape[1]
    mask = prefix_lm_mask(p + s, p, batch["inputs"].device)
    hidden, aux = lm.lm_hidden(params, batch["inputs"], cfg, mask=mask,
                               prefix_embeds=patches, remat=remat)
    logits = lm.lm_logits(params, hidden[:, p:], cfg)
    loss, metrics = softmax_cross_entropy(logits, batch["targets"])
    metrics["aux_loss"] = aux
    return loss + aux, metrics


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int, *,
                      device=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    return lm.init_decode_state(cfg, batch, max_seq, device=device,
                                dtype=dtype)


def decode_step(params: lm.LM, state: dict, tokens: torch.Tensor,
                cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    return lm.decode_step(params, state, tokens, cfg)
