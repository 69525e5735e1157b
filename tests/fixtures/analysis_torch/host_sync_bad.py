"""Fixture: every host-sync family on a kernel wrapper's device path.

Never imported — parsed by `tests/test_torch_analysis.py` under the name
``repro_torch.kernels.fake.kernel``, so its public functions root the
port's kernel-path purity pass, which must flag each marked line.
"""
import torch

from repro_torch.kernels.fake import ref


def _extent(grids):
    return int(grids.max())          # host-sync, reached from `launch`


def launch(x, grids):
    if x.device.type == "cpu":
        return ref.plain(x)
    n = x.sum().item()               # host-sync: .item()
    ext = grids.cpu()                # host-sync: .cpu()
    rows = x.tolist()                # host-sync: .tolist()
    torch.cuda.synchronize()         # host-sync: a device-wide wait
    if bool((x < 0).any() | (x > 9).any()):   # host-sync: bool(reduction)
        raise ValueError("out of range")
    return n, ext, rows, _extent(grids)
