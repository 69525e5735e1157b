"""Device meshes: named axes over positions held by this one process.

Counterpart of `repro.launch.mesh`.  A `Mesh` has `axis_names`, a
`shape` dict (axis -> size, in axis order, as the reference's) and
`positions`, an object array of that shape holding a `torch.device` at
each position, or None for an abstract mesh (shapes only: the dry-run's
production meshes).  As in `parallel.distributed_explorer`, positions may
repeat: a 2 x 2 mesh on one card is four `cuda:0` positions, on the CPU
four `cpu` positions.  The calling thread issues every position's work
to its device in turn; a card runs what it was given while the thread
issues another card's, and the train step's backward runs on autograd's
thread of each device (`launch.steps`), so positions on four cards
compute at once and positions sharing a device one after another.
`mesh.positions.ravel()` is the flat tuple the mesh explorer takes.

Single pod: 16 x 16 positions, axes ("data", "model"); multi-pod: 2 x 16
x 16 with an outer "pod" axis.  The production meshes are abstract here:
they size the dry-run's cells (`launch/dryrun.py`), and no process holds
512 positions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class Mesh:
    """Named axes over device positions (see the module's docstring)."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...],
                 positions=None):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes}")
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.positions = None
        if positions is not None:
            flat = [torch.device(p) for p in np.asarray(
                positions, dtype=object).ravel()]
            if len(flat) != int(np.prod(shape)):
                raise ValueError(f"{len(flat)} positions for a mesh of "
                                 f"shape {shape}")
            arr = np.empty(len(flat), dtype=object)
            arr[:] = flat
            self.positions = arr.reshape(shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def coords(self, flat: int) -> dict[str, int]:
        """The axis coordinates of the position at flat (row-major) index
        `flat`."""
        idx = np.unravel_index(flat, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def device(self, flat: int) -> torch.device:
        if self.positions is None:
            raise ValueError("an abstract mesh holds no devices")
        return self.positions.ravel()[flat]

    def __repr__(self) -> str:
        where = "abstract" if self.positions is None else sorted(
            {str(d) for d in self.positions.ravel()})
        return f"Mesh({self.shape}, {where})"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], positions=None,
              *, device=None) -> Mesh:
    """A mesh of `shape` over `axes`.  `positions` (any sequence of
    devices, row-major) places it; without them it takes `device`'s
    kind: the local cards round-robin for CUDA (the default, raising
    without a card), or every position on `device` otherwise
    (`device="cpu"`)."""
    n = int(np.prod(shape))
    if positions is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            cards = torch.cuda.device_count()
            positions = [torch.device("cuda", i % cards) for i in range(n)]
        else:
            positions = [dev] * n
    return Mesh(shape, axes, positions)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, abstract (no devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def dp_size(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in ("pod", "data")
                        if a in mesh.axis_names]))
