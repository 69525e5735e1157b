"""`ctypes` wrapper of the flash attention CUDA kernel
(`csrc/flash_attention.cu`).

`flash_attention` replaces `repro.kernels.flash_attention.kernel.
flash_attention_kernel` (online-softmax attention, the running max, sum
and accumulator in float32).  It takes the model's layout, q (B, S, H,
Dh) and k / v (B, T, KV, Dh), and reads KV head h // (H // KV) for query
head h by index (the reference's `ops` repeats KV heads in memory
instead).  For tensors on the CPU the wrapper runs the plain version
(`ref.flash_attention_ref`); for CUDA tensors it launches the kernel,
counts the launch in `repro_torch.kernels.LAUNCHES`, and raises on a
launch error.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention.argtypes = [
            p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
            i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        lib.flash_attention.restype = i
        _LIB = lib
    return _LIB


def kernel_layout_ok(t: torch.Tensor) -> bool:
    """What the kernel's 16-byte loads need: unit stride on Dh, the
    other strides multiples of 8 elements, a 16-byte aligned pointer."""
    return (t.stride(3) == 1 and all(st % 8 == 0 for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0,
                    block_k: int = ref.KV_TILE) -> torch.Tensor:
    """q: (B, S, H, Dh); k/v: (B, T, KV, Dh); one dtype, bfloat16 or
    float32; H % KV == 0; Dh in `HEAD_DIMS`.  Returns (B, S, H, Dh)
    contiguous in q's dtype.  `block_k` is the plain version's KV block;
    the kernel streams 64-key tiles."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B, S, H, Dh), k/v (B, T, KV, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh
            or kvh == 0 or h % kvh):
        raise ValueError(f"k/v must be (B, T, KV, Dh) with H % KV == 0; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention supports head dims {HEAD_DIMS}, "
                         f"not {dh}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {DTYPES}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       prefix_len=prefix_len, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not kernel_layout_ok(x):
            raise ValueError(f"{name}: the kernel needs unit stride on Dh, "
                             f"strides that are multiples of 8 and a 16-byte "
                             f"aligned pointer; got strides {x.stride()} "
                             f"(ops.flash_attention copies such inputs)")
    if -(-s // 64) * b * h >= 2 ** 31:
        raise ValueError(f"grid of {-(-s // 64) * b * h} CTAs is too large")
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    scale = float(np.float32(1.0 / dh ** 0.5))
    rc = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, s, t, h, kvh, dh, int(q.dtype == torch.bfloat16), int(causal),
        prefix_len, scale, _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
