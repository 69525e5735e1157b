"""Device resolution for the port's entry points.

The rule: an entry point runs on `cuda` by default.  With no CUDA
device it raises, unless the caller names a device explicitly
(`device="cpu"`, as the CPU tests do).  Nothing falls back to the CPU
on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> `cuda` (raises when no CUDA device is present); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
