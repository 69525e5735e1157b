"""Step builders: the train step, the prefill forward and the decode step
of every family of the LM substrate (dense, MoE, VLM, hybrid, SSM, and
the audio family's encoder-decoder).

Counterpart of `repro.launch.steps` on one device.  The reference jits
each step with the sharding policy of a mesh; the port runs eagerly on
one device and has no mesh (the sharding rules have no counterpart
until `parallel/*` is ported).  The train step reaches no kernel of
ours: the reference's train step reaches no Pallas kernel either (dense
attention, products outside any kernel), so it is PyTorch and cuBLAS.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Callable

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch import shapes as shp
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import lm, whisper
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw


def default_opt_cfg(cfg: ArchConfig) -> adamw.AdamWConfig:
    """Per-arch optimizer memory policy (the reference's): int8 blockwise
    moments for the 480B config, bf16 moments for granite-34b."""
    if cfg.name == "arctic-480b":
        return adamw.AdamWConfig(quantized_moments=True)
    if cfg.name == "granite-34b":
        return adamw.AdamWConfig(moment_dtype=torch.bfloat16)
    return adamw.AdamWConfig()


# master-parameter dtype of a config's leaves of stacked rank >= 2, where
# it is not float32 (the reference's).  Only arctic has one.  The port
# builds and serves the MoE family, but its training waits for the
# sharded mesh (ROADMAP queue 1, "training of the MoE family on the
# card"): nothing here reads this yet, and every master trained on one
# card is float32.
PARAM_DTYPE = {"arctic-480b": torch.bfloat16}


def accum_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.name == "arctic-480b" else torch.float32


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrainStep:
    fn: Callable[[dict, dict], tuple[dict, dict]]  # (state, batch) -> ...
    batch_struct: dict       # train_4k's batch as `shapes.TensorSpec`s
    opt_cfg: adamw.AdamWConfig
    device: torch.device


def _cast_view(module: nn.Module, dtype: torch.dtype, prefix: str = ""):
    """`module`'s parameters as a tree of namespaces that the model
    functions read like the module (`p.attn.wq`), each float32 leaf of
    stacked rank >= 2 cast to `dtype` (differentiable: the grads reach
    the float32 masters through the cast).  A namespace, not the module
    with swapped parameters, so a block recomputed under remat reads
    the same cast tensors."""
    if isinstance(module, nn.ModuleList):
        return [_cast_view(m, dtype, f"{prefix}{i}.")
                for i, m in enumerate(module)]
    out = types.SimpleNamespace()
    for name, p in module.named_parameters(recurse=False):
        cast = (p.dtype == torch.float32
                and lm.stacked_ndim(prefix + name, p) >= 2)
        setattr(out, name, p.to(dtype) if cast else p)
    for name, m in module.named_children():
        setattr(out, name, _cast_view(m, dtype, f"{prefix}{name}."))
    return out


def make_train_step(cfg: ArchConfig, *,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    microbatches: int = 1, remat: bool = True,
                    cast_bf16: bool = False, device=None) -> TrainStep:
    """The train step on `device` (CUDA when None, raising without it).

    `fn(state, batch)` takes `state = {"params": the model, "opt": adamw
    state, "step": int32 0-dim tensor}` (`train.trainer.init_state`) and
    a batch of `inputs` / `targets` (B, S) (the VLM's also `patches` (B,
    P, D), the audio family's `frames` (B, F, D)); it runs the model's
    loss (`lm_loss`, `paligemma_loss` for the VLM, `whisper_loss` for the
    audio family: dense attention, bf16 products, remat per block when
    `remat`, for the hybrid family per group with each Mamba2 layer
    inside it; the SSM family's mLSTM chunkwise, as the reference's),
    backward and AdamW,
    writes the parameters and moments in place (the reference donates
    its state) and returns (state, metrics): `lm_loss`'s metrics, AdamW's
    and `loss`, 0-dim tensors on the device.

    With `microbatches` > 1 the batch's rows are cut into that many
    consecutive slices; their grads are summed in `.grad` (float32, the
    dense configs' `accum_dtype`, from zero as the reference's `gacc`)
    and divided by the count, the loss is their mean and the other
    metrics are the last microbatch's.  `cast_bf16` runs the loss on a
    bf16 cast of the float32 leaves of stacked rank >= 2."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or default_opt_cfg(cfg)
    api = build_model(cfg, remat=remat, mlstm_chunked=(cfg.family == "ssm"))

    def loss_fn(params, mb: dict):
        if cast_bf16:
            params = _cast_view(params, torch.bfloat16)
        return api.loss(params, mb)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model = state["params"]
        named = dict(model.named_parameters())
        for p in named.values():
            p.grad = None
        batch = {k: v.to(dev) for k, v in batch.items()}
        rows = batch["inputs"].shape[0]
        if rows % microbatches:
            raise ValueError(f"batch of {rows} rows in {microbatches} "
                             f"microbatches")
        per = rows // microbatches
        loss = None
        for i in range(microbatches):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            mb_loss, metrics = loss_fn(model, mb)
            mb_loss.backward()
            mb_loss = mb_loss.detach()
            loss = mb_loss if loss is None else loss + mb_loss
        grads = {n: p.grad for n, p in named.items()}
        if microbatches > 1:
            loss = loss / microbatches
            for g in grads.values():
                g.div_(microbatches)
        _, state["opt"], opt_metrics = adamw.update(grads, state["opt"],
                                                    named, opt_cfg)
        for p in named.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, **opt_metrics, loss=loss)
        state["step"] = state["step"] + 1
        return state, metrics

    return TrainStep(fn=train_step,
                     batch_struct=shp.batch_struct(cfg, shp.SHAPES["train_4k"]),
                     opt_cfg=opt_cfg, device=dev)


# ---------------------------------------------------------------------------
# prefill (forward-only logits)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PrefillStep:
    fn: Callable[[torch.nn.Module, dict], torch.Tensor]
    # the shape's batch: inputs (B, S); the VLM's also patches (B, P, D),
    # the audio family's frames (B, F, D)
    batch_shapes: dict[str, tuple[int, ...]]
    device: torch.device


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec, *,
                      device=None) -> PrefillStep:
    """Forward-only logits of the prefill shape `shape` on `device`
    (CUDA when None, raising without it).

    `fn(params, batch)` returns the logits of `lm_hidden(params,
    batch["inputs"], cfg, attn_impl="blockwise")` under
    `torch.inference_mode()`: logits at every position, in the hidden
    dtype (bf16).  The hybrid family's prefill runs its Mamba2 layers'
    chunked SSD and the shared block's blockwise attention (zamba2-2.7b:
    head dim 80, `flash_attention_wgmma` at (80, 80) on the card); the SSM
    family's its mLSTM chunkwise and its sLSTM's loop over time.  The
    VLM family's batch also carries `patches` (B, P, D), prepended as
    `prefix_embeds` (attention bidirectional over them):
    its logits cover the P + S positions, patches included, as the
    reference's do.  The audio family's carries `frames` (B, F, D): the
    encoder runs over them (dense attention), then the decoder over the
    tokens with blockwise self-attention (whisper-large-v3: head dim 64,
    `flash_attention_wgmma` at (64, 64) on the card) and dense
    cross-attention.  `params` is the model on the step's device, as
    its `init(device=..., dtype=torch.bfloat16)` gives the serving
    weights."""
    dev = resolve_device(device)
    build_model(cfg)
    shapes = {"inputs": (shape.batch, shape.seq)}
    if cfg.family == "vlm":
        shapes["patches"] = (shape.batch, cfg.vlm.n_patches, cfg.d_model)
    if cfg.family == "audio":
        shapes["frames"] = (shape.batch, cfg.encdec.enc_frames, cfg.d_model)

    def prefill(params, batch: dict) -> torch.Tensor:
        with torch.inference_mode():
            if cfg.family == "audio":
                enc = whisper.encode(params, batch["frames"].to(dev), cfg)
                return whisper.decode_fwd(params, batch["inputs"].to(dev),
                                          enc, cfg, attn_impl="blockwise")
            prefix = (batch["patches"].to(dev) if cfg.family == "vlm"
                      else None)
            hidden, _ = lm.lm_hidden(params, batch["inputs"].to(dev), cfg,
                                     prefix_embeds=prefix,
                                     attn_impl="blockwise",
                                     mlstm_chunked=(cfg.family == "ssm"))
            return lm.lm_logits(params, hidden, cfg)

    return PrefillStep(fn=prefill, batch_shapes=shapes, device=dev)


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeStep:
    fn: Callable[[torch.nn.Module, dict, torch.Tensor],
                 tuple[torch.Tensor, dict]]
    init_state: Callable[[], dict]   # a fresh decode state of the shape
    tokens_shape: tuple[int, ...]    # (B,)
    device: torch.device


def make_serve_step(cfg: ArchConfig, shape: ShapeSpec, *,
                    device=None) -> ServeStep:
    """One decode step of the decode shape `shape` (batch B, cache of
    `shape.seq` positions) on `device` (CUDA when None, raising without
    it): `fn(params, state, tokens)` is `decode_step` (logits (B, V)
    float32, the state written in place), `init_state()` the zeroed
    state (`init_decode_state`); `params` are the serving weights."""
    dev = resolve_device(device)
    api = build_model(cfg)
    return ServeStep(
        fn=api.decode_step,
        init_state=lambda: api.init_decode_state(shape.batch, shape.seq,
                                                 device=dev),
        tokens_shape=(shape.batch,), device=dev)
