"""Fixture: a kernel family's `ops.py` that breaks the no-fallback
contract — parsed as ``repro_torch.kernels.fake.ops`` so the host-guard
rule applies.
"""
from repro_torch.kernels.fake import kernel, ref


def dispatch(x):
    try:
        return kernel.launch(x)
    except RuntimeError:
        return ref.plain(x)          # host-guard: falls back on an error


def unfenced(x):
    return ref.plain(x)              # host-guard: no CPU-device fence
