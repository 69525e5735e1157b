"""Assigned input-shape sets (copied from `repro.launch.shapes`).

    train_4k     seq 4,096   global_batch 256   (training -> train_step)
    prefill_32k  seq 32,768  global_batch 32    (inference prefill forward)
    decode_32k   seq 32,768  global_batch 128   (serve_step, KV cache 32k)
    long_500k    seq 524,288 global_batch 1     (serve_step; SSM/hybrid only)

The port runs `prefill_32k` (`repro_torch.launch.steps.make_prefill_step`).
"""
from __future__ import annotations

import dataclasses


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
