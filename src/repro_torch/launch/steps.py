"""Step builders: the train step, the prefill forward and the decode step
of the LM (the dense and MoE families).

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
from repro_torch.models import lm
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

    `fn(state, batch)` takes `state = {"params": LM, "opt": adamw state,
    "step": int32 0-dim tensor}` (`train.trainer.init_state`) and a batch
    of `inputs` / `targets` (B, S); it runs `lm_loss` (dense attention,
    bf16 products, remat per block when `remat`), backward and AdamW,
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
    api = build_model(cfg, remat=remat)

    def loss_fn(params: lm.LM, mb: dict):
        if cast_bf16:
            params = _cast_view(params, torch.bfloat16)
        return api.loss(params, mb)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        model: lm.LM = state["params"]
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
    fn: Callable[[lm.LM, dict], torch.Tensor]
    batch_shapes: dict[str, tuple[int, ...]]   # the shape's batch: inputs (B, S)
    device: torch.device


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec, *,
                      device=None) -> PrefillStep:
    """Forward-only logits of the prefill shape `shape` on `device`
    (CUDA when None, raising without it).

    `fn(params, batch)` returns the logits of `lm_hidden(params,
    batch["inputs"], cfg, attn_impl="blockwise")` under
    `torch.inference_mode()`: logits at every position, in the hidden
    dtype (bf16).  `params` is an `LM` on the step's device, as
    `init_lm(cfg, device=..., dtype=torch.bfloat16)` gives the serving
    weights."""
    dev = resolve_device(device)
    lm.check_dense(cfg)

    def prefill(params: lm.LM, batch: dict) -> torch.Tensor:
        with torch.inference_mode():
            hidden, _ = lm.lm_hidden(params, batch["inputs"].to(dev), cfg,
                                     attn_impl="blockwise")
            return lm.lm_logits(params, hidden, cfg)

    return PrefillStep(fn=prefill,
                       batch_shapes={"inputs": (shape.batch, shape.seq)},
                       device=dev)


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeStep:
    fn: Callable[[lm.LM, dict, torch.Tensor], tuple[torch.Tensor, dict]]
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
