"""PyTorch/CUDA port of the EasyACIM reproduction.

Mirrors the layout of the JAX package `repro` module for module, so each
function has a counterpart of the same name.  Plain tensor code is
PyTorch; every Pallas kernel of the JAX package on the ported path is a
hand-written CUDA C++ kernel for Hopper (`repro_torch/csrc/`), built
with `nvcc` at first use and loaded with `ctypes`.

Entry points run on `cuda` unless the caller passes `device="cpu"`;
with no CUDA device and no explicit device they raise
(`repro_torch.device.resolve_device`).
"""
