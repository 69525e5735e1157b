"""Fixture: the sync-free twin of `host_sync_bad.py` (parsed as
``repro_torch.kernels.fake.kernel``).  Reads behind the CPU-device fence
run on CPU tensors only, and a reduction over a numpy array is host
arithmetic: the pass must report nothing.
"""
import numpy as np
import torch

from repro_torch.kernels.fake import ref


def launch(x, shape):
    if x.device.type == "cpu":
        y = ref.plain(x)
        return int(y.max().item())   # plain-only: a CPU tensor
    g = np.asarray(shape).astype(np.int64)
    n = int(g.max())                 # numpy: no device involved
    return torch.empty(n, device=x.device)


def checked(x):
    if x.device.type != "cpu":
        return torch.neg(x)
    return x.numpy()                 # after a leaving fence: CPU only
