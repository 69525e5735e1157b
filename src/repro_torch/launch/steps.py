"""Step builders: the prefill forward of the dense LM.

Counterpart of the prefill part of `repro.launch.steps`.  The reference
jits the step with the sharding policy of a mesh; the port runs eagerly
on one device and has no mesh (the sharding rules have no counterpart
until `parallel/*` is ported).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class PrefillStep:
    fn: Callable[[lm.LM, dict], torch.Tensor]
    batch_shapes: dict[str, tuple[int, ...]]   # the shape's batch: inputs (B, S)
    device: torch.device


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec, *,
                      device=None) -> PrefillStep:
    """Forward-only logits of the prefill shape `shape` on `device`
    (CUDA when None, raising without it).

    `fn(params, batch)` returns `lm_logits(lm_hidden(params,
    batch["inputs"], cfg, attn_impl="blockwise"))` under
    `torch.inference_mode()`: logits at every position, in the hidden
    dtype (bf16).  `params` is an `LM` on the step's device, as
    `init_lm(cfg, device=..., dtype=torch.bfloat16)` gives the serving
    weights."""
    dev = resolve_device(device)
    lm.check_dense(cfg)

    def prefill(params: lm.LM, batch: dict) -> torch.Tensor:
        with torch.inference_mode():
            hidden = lm.lm_hidden(params, batch["inputs"].to(dev), cfg,
                                  attn_impl="blockwise")
            return lm.lm_logits(params, hidden, cfg)

    return PrefillStep(fn=prefill,
                       batch_shapes={"inputs": (shape.batch, shape.seq)},
                       device=dev)
