"""Fixture: the compliant twin of `host_guard_bad.py` (parsed as
``repro_torch.kernels.fake.ops``): the plain version runs only behind a
CPU-device fence, and a failed launch raises.
"""
from repro_torch.kernels.fake import kernel, ref


def dispatch(x):
    if x.device.type == "cpu":
        return ref.plain(x)
    return kernel.launch(x)


def checked(x):
    if x.device.type != "cpu":
        return kernel.launch(x)
    return ref.plain(x)
