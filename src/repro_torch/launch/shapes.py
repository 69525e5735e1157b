"""Assigned input-shape sets and per-(arch x shape) batch specs (copied
from `repro.launch.shapes`).

    train_4k     seq 4,096   global_batch 256   (training -> train_step)
    prefill_32k  seq 32,768  global_batch 32    (inference prefill forward)
    decode_32k   seq 32,768  global_batch 128   (serve_step, KV cache 32k)
    long_500k    seq 524,288 global_batch 1     (serve_step; SSM/hybrid only)

`long_500k` requires sub-quadratic sequence mixing; pure full-attention
archs skip it.  `batch_struct` gives shapes and dtypes as `TensorSpec`s
(the reference's `ShapeDtypeStruct`s).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig


class TensorSpec(NamedTuple):
    """The shape and dtype of a tensor that is not made yet."""
    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(sub-quadratic required; pure full-attention arch)"
    return True, ""


def batch_struct(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Global-shape `TensorSpec`s of the training / prefill batch."""
    b, s = shape.batch, shape.seq
    batch = {"inputs": TensorSpec((b, s), torch.int32),
             "targets": TensorSpec((b, s), torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = TensorSpec(
            (b, cfg.encdec.enc_frames, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        batch["patches"] = TensorSpec(
            (b, cfg.vlm.n_patches, cfg.d_model), torch.float32)
    return batch


# per-(arch, shape) microbatch-count overrides for activation memory:
# remat saves one (B/mb, S, D) residual per layer, so mb is sized to keep
# n_layers * B_loc/mb * S * D * 2B (+ family transients) under ~4 GB/chip.
MICROBATCHES: dict[tuple[str, str], int] = {
    ("qwen2.5-3b", "train_4k"): 4,
    ("qwen3-8b", "train_4k"): 8,
    ("codeqwen1.5-7b", "train_4k"): 8,
    ("granite-34b", "train_4k"): 8,
    ("arctic-480b", "train_4k"): 4,
    ("deepseek-v2-lite-16b", "train_4k"): 4,
    ("whisper-large-v3", "train_4k"): 4,
    ("zamba2-2.7b", "train_4k"): 8,
    ("xlstm-125m", "train_4k"): 4,
    ("paligemma-3b", "train_4k"): 4,
}


def microbatches_for(cfg: ArchConfig, shape: ShapeSpec) -> int:
    return MICROBATCHES.get((cfg.name, shape.name), 1)
