"""`ctypes` wrapper of the acim_matmul CUDA kernel (`csrc/acim_matmul.cu`).

`acim_matmul` replaces `repro.kernels.acim_matmul.kernel.acim_matmul_kernel`
(the bit-serial QR macro: per N-row chunk an exact float32 partial sum
through the SAR ADC, chunks accumulated digitally).  For tensors on the
CPU the wrapper runs the plain version (`ref.py`); for CUDA tensors it
launches the kernel, counts the launch in
`repro_torch.kernels.LAUNCHES`, and raises on a launch error.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.acim_matmul import ref

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("acim_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.acim_matmul.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.acim_matmul.restype = i
        _LIB = lib
    return _LIB


def acim_matmul(x: torch.Tensor, w: torch.Tensor, n: int,
                b_adc: int) -> torch.Tensor:
    """x: (M, K) float32, w: (K, C) float32, both contiguous on one
    device, K a multiple of the chunk size `n` (ops pads).  Returns
    (M, C) float32: y = sum over K-chunks of ADC_b(x_c @ w_c)."""
    if (x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]
            or x.dtype != torch.float32 or w.dtype != torch.float32
            or not x.is_contiguous() or not w.is_contiguous()):
        raise ValueError(f"expected contiguous float32 (M, K) @ (K, C), got "
                         f"{tuple(x.shape)} {x.dtype} @ {tuple(w.shape)} "
                         f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    m, k = x.shape
    c = w.shape[1]
    if n < 2 or k % n or not 1 <= b_adc <= 16:
        raise ValueError(f"need K % n == 0, n >= 2, 1 <= b_adc <= 16; got "
                         f"K={k}, n={n}, b_adc={b_adc}")
    if x.device.type == "cpu":
        return ref.acim_matmul_ref(x, w, n=n, b_adc=b_adc)
    if x.device.type != "cuda":
        raise ValueError(f"acim_matmul runs on cpu or cuda, not {x.device}")
    out = torch.empty((m, c), dtype=torch.float32, device=x.device)
    if m == 0 or c == 0:
        return out
    rc = _lib().acim_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                            m, k, c, n, b_adc, _build.stream_ptr(x))
    _build.check(rc, "acim_matmul")
    LAUNCHES["acim_matmul"] += 1
    return out
