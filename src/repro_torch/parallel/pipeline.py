"""Pipeline parallelism: a GPipe schedule over a mesh axis.

Counterpart of `repro.parallel.pipeline`.  `pipeline_apply` runs S
stages over M microbatches in M + S - 1 ticks: stage i's slice of the
stage parameters lives on the i-th position along the stage axis, and
each tick every busy stage runs its microbatch and hands the activation
to the next stage's position with `.to(device)` (the reference's
`ppermute`); bubble fraction (S-1)/(M+S-1), matching the GPipe analysis.
The outputs are collected from the last stage onto the first position.
Autograd runs back through the same copies, so the schedule is
differentiable end to end and serves training.

Positions run one after another from this thread, as the mesh
explorer's do (`parallel.distributed_explorer`): on one card (or the
CPU) the schedule computes what the sequential model computes; across
cards the ticks of different stages can overlap where nothing waits.
"""
from __future__ import annotations

from typing import Callable

import torch


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _stage_devices(mesh, stage_axis: str) -> list[torch.device]:
    """The positions along `stage_axis`, the other axes at 0."""
    idx = [0] * len(mesh.axis_names)
    out = []
    for i in range(mesh.shape[stage_axis]):
        idx[mesh.axis_names.index(stage_axis)] = i
        out.append(mesh.positions[tuple(idx)])
    return out


def pipeline_apply(mesh, stage_axis: str,
                   stage_fn: Callable[[object, torch.Tensor], torch.Tensor],
                   stage_params, microbatches: torch.Tensor) -> torch.Tensor:
    """Run `stage_fn` as an S-stage pipeline.

    stage_params: a tensor, or a dict / tuple of tensors, with a leading
    stage axis S (stage i's slice goes to the i-th position along
    `stage_axis`); microbatches: (M, B, ...) activations.  Returns the
    (M, B, ...) outputs on the first position."""
    devs = _stage_devices(mesh, stage_axis)
    n_stages = len(devs)
    m = microbatches.shape[0]
    params = [_map(lambda a, i=i: a[i].to(devs[i]), stage_params)
              for i in range(n_stages)]
    inbox: list = [None] * n_stages      # the activation entering stage s
    outs: list = [None] * m
    for t in range(m + n_stages - 1):
        nxt: list = [None] * n_stages
        for s in range(n_stages):
            k = t - s                      # the microbatch at stage s
            if not 0 <= k < m:
                continue
            x = microbatches[k].to(devs[0]) if s == 0 else inbox[s]
            y = stage_fn(params[s], x)
            if s == n_stages - 1:
                outs[k] = y.to(devs[0])
            else:
                nxt[s + 1] = y.to(devs[s + 1])
        inbox = nxt
    return torch.stack(outs)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
