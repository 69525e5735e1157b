"""`ctypes` wrappers of the acim_matmul CUDA kernels.

Both replace `repro.kernels.acim_matmul.kernel.acim_matmul_kernel` (the
bit-serial QR macro: per N-row chunk an exact float32 partial sum through
the SAR ADC, chunks accumulated digitally).  Two routes, chosen by the
chunk size N (`route`):

- "wgmma" (`csrc/acim_matmul_wgmma.cu`), N a multiple of 16: bf16 tensor
  cores on an exact three-term split of each float32 operand, the ADC in
  registers, K split across CTAs at chunk boundaries where that keeps the
  sum exact (`split_k`);
- "cuda_core" (`csrc/acim_matmul.cu`), every other N (the explorer's
  space holds N = 4 and 8): float32 FFMA on the CUDA cores.

For tensors on the CPU `acim_matmul` runs the plain version (`ref.py`);
for CUDA tensors it launches the route's kernel, counts the launch in
`repro_torch.kernels.LAUNCHES["acim_matmul"]` and under the route's own
key (`acim_matmul_wgmma`, `acim_matmul_cuda_core`), and raises on a
launch error.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.acim_matmul import ref

# The wgmma kernel's output tile; split_k fills the card with these.
TILE_M = TILE_N = 128

_FNS: dict = {}
_FNS_LOCK = threading.Lock()   # first calls may race from several threads


def _fn(name: str):
    with _FNS_LOCK:
        fn = _FNS.get(name)
        if fn is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            fn = getattr(_build.load(name), name)
            fn.argtypes = ([p, p, p, i, i, i, i, i, p]
                           if name == "acim_matmul"
                           else [p, p, p, i, i, i, i, i, i, p])
            fn.restype = i
            _FNS[name] = fn
        return fn


def route(n: int) -> str:
    """The kernel that runs chunk size `n`: "wgmma" (tensor cores) where
    a chunk is whole k16 steps, else "cuda_core"."""
    return "wgmma" if n % 16 == 0 else "cuda_core"


def split_k(m: int, c: int, k: int, n: int, sms: int) -> int:
    """How many CTAs share an output tile's K on the wgmma route: enough
    to bring the grid's CTAs up to one per SM, in whole chunks, and only
    where N is a power of two (delta = 2N / 2^B is one too, so the
    cross-CTA sum of ADC outputs is exact in any order)."""
    chunks = k // n
    tiles = -(-m // TILE_M) * -(-c // TILE_N)
    if n & (n - 1) or chunks < 2 or tiles == 0 or tiles >= sms:
        return 1
    return max(1, min(chunks, sms // tiles))


def _check(x: torch.Tensor, w: torch.Tensor, n: int, b_adc: int) -> None:
    if (x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]
            or x.dtype != torch.float32 or w.dtype != torch.float32
            or not x.is_contiguous() or not w.is_contiguous()):
        raise ValueError(f"expected contiguous float32 (M, K) @ (K, C), got "
                         f"{tuple(x.shape)} {x.dtype} @ {tuple(w.shape)} "
                         f"{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    k = x.shape[1]
    if n < 2 or k % n or not 1 <= b_adc <= 16:
        raise ValueError(f"need K % n == 0, n >= 2, 1 <= b_adc <= 16; got "
                         f"K={k}, n={n}, b_adc={b_adc}")


def acim_matmul(x: torch.Tensor, w: torch.Tensor, n: int,
                b_adc: int) -> torch.Tensor:
    """x: (M, K) float32, w: (K, C) float32, both contiguous on one
    device, K a multiple of the chunk size `n` (ops pads; on the wgmma
    route also C to a multiple of 4).  Returns (M, C) float32: y = sum
    over K-chunks of ADC_b(x_c @ w_c), on `route(n)`'s kernel."""
    _check(x, w, n, b_adc)
    if x.device.type == "cpu":
        return ref.acim_matmul_ref(x, w, n=n, b_adc=b_adc)
    if route(n) == "wgmma":
        return acim_matmul_wgmma(x, w, n, b_adc)
    return acim_matmul_cuda_core(x, w, n, b_adc)


def _out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the acim_matmul kernels run on cuda, not "
                         f"{x.device}")
    return torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                       device=x.device)


def _count(name: str) -> None:
    count_launch("acim_matmul")
    count_launch(name)


def acim_matmul_cuda_core(x: torch.Tensor, w: torch.Tensor, n: int,
                          b_adc: int) -> torch.Tensor:
    """The CUDA-core kernel (any N >= 2), CUDA tensors only."""
    _check(x, w, n, b_adc)
    out = _out(x, w)
    m, k = x.shape
    if out.numel() == 0:
        return out
    _build.launch(x, _fn("acim_matmul"), "acim_matmul", x.data_ptr(),
                  w.data_ptr(), out.data_ptr(), m, k, w.shape[1], n, b_adc)
    _count("acim_matmul_cuda_core")
    return out


def acim_matmul_wgmma(x: torch.Tensor, w: torch.Tensor, n: int, b_adc: int,
                      splits: int | None = None) -> torch.Tensor:
    """The tensor-core kernel, CUDA tensors only: N % 16 == 0, C % 4 == 0
    (16-byte rows).  `splits` CTAs share each output tile's K (default
    `split_k`; more than 1 only where N is a power of two)."""
    _check(x, w, n, b_adc)
    m, k = x.shape
    c = w.shape[1]
    if n % 16 or c % 4:
        raise ValueError(f"the wgmma route needs N % 16 == 0 and C % 4 == "
                         f"0; got N={n}, C={c}")
    if splits is not None and (splits < 1 or (splits > 1 and n & (n - 1))):
        raise ValueError(f"splits={splits} at N={n}: K splits only where N "
                         f"is a power of two")
    out = _out(x, w)
    if out.numel() == 0:
        return out
    if splits is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = split_k(m, c, k, n, sms)
    _build.launch(x, _fn("acim_matmul_wgmma"), "acim_matmul_wgmma",
                  x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, c, n,
                  b_adc, splits)
    _count("acim_matmul_wgmma")
    return out
