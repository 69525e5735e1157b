"""`ctypes` wrappers of the acim_matmul CUDA kernels.

All replace `repro.kernels.acim_matmul.kernel.acim_matmul_kernel` (the
bit-serial QR macro: per N-row chunk an exact float32 partial sum through
the SAR ADC, chunks accumulated digitally).  Three routes, chosen by the
chunk size N (`route`):

- "wgmma" (`csrc/acim_matmul_wgmma.cu`), N a multiple of 16: bf16 tensor
  cores on an exact three-term split of each float32 operand, the ADC in
  registers, K split across CTAs at chunk boundaries where that keeps the
  sum exact (`split_k`);
- "mma" (`csrc/acim_matmul_mma.cu`), N 2, 4 and 8 (the explorer's narrow
  macros): `mma.sync` m16n8k8 on the same split, one chunk a k8 step's
  lanes, the ADC in three instructions a conversion, K split across CTAs
  in whole k-tiles (`mma_split_k`);
- "cuda_core" (`csrc/acim_matmul.cu`), every other N (12, 24, 40, ...:
  no macro of the explorer's space): float32 FFMA on the CUDA cores.

For tensors on the CPU `acim_matmul` runs the plain version (`ref.py`);
for CUDA tensors it launches the route's kernel, counts the launch in
`repro_torch.kernels.LAUNCHES["acim_matmul"]` and under the route's own
key (`acim_matmul_wgmma`, `acim_matmul_mma`, `acim_matmul_cuda_core`),
and raises on a launch error.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.acim_matmul import ref

# The wgmma kernel's output tile; split_k fills the card with these.
TILE_M = TILE_N = 128
# The mma kernel's output tile and k-tile, and the chunk sizes it takes.
MMA_TILE_M, MMA_TILE_N, MMA_TILE_K = 128, 64, 32
MMA_N = (2, 4, 8)

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
    a chunk is whole k16 steps, "mma" (tensor cores, a chunk the lanes of
    a k8 step) at N 2, 4 and 8, else "cuda_core"."""
    if n % 16 == 0:
        return "wgmma"
    return "mma" if n in MMA_N else "cuda_core"


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


def mma_split_k(m: int, c: int, k: int, sms: int) -> int:
    """How many CTAs share an output tile's K on the mma route (whole
    k-tiles; every N it takes is a power of two, so the cross-CTA sum is
    exact in any order).  Where the grid has fewer tiles than SMs, the
    fewest splits s (up to 8) whose busiest SM's share of the work,
    ceil(tiles s / sms) / s of a tile's, is within 5 % of the least: at
    the FFN's down projection (96 tiles of 128 x 64, 132 SMs) 4 splits,
    384 CTAs (0.75 of a tile an SM against 1 for 1-3 splits)."""
    k_tiles = -(-k // MMA_TILE_K)
    tiles = -(-m // MMA_TILE_M) * -(-c // MMA_TILE_N)
    if k_tiles < 2 or tiles == 0 or tiles >= sms:
        return 1
    load = {s: -(-tiles * s // sms) / s for s in range(1, min(8, k_tiles) + 1)}
    least = min(load.values())
    return min(s for s, v in load.items() if v <= 1.05 * least)


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
    route also C to a multiple of 4, on the mma route K and C).  Returns
    (M, C) float32: y = sum over K-chunks of ADC_b(x_c @ w_c), on
    `route(n)`'s kernel."""
    _check(x, w, n, b_adc)
    if x.device.type == "cpu":
        return ref.acim_matmul_ref(x, w, n=n, b_adc=b_adc)
    r = route(n)
    if r == "wgmma":
        return acim_matmul_wgmma(x, w, n, b_adc)
    if r == "mma":
        return acim_matmul_mma(x, w, n, b_adc)
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


def acim_matmul_mma(x: torch.Tensor, w: torch.Tensor, n: int, b_adc: int,
                    splits: int | None = None) -> torch.Tensor:
    """The tensor-core kernel for N 2, 4 and 8, CUDA tensors only: K % 4
    == 0 and C % 4 == 0 (16-byte rows), both operands 16-byte aligned.
    `splits` CTAs share each output tile's K (default `mma_split_k`)."""
    _check(x, w, n, b_adc)
    m, k = x.shape
    c = w.shape[1]
    if n not in MMA_N or k % 4 or c % 4:
        raise ValueError(f"the mma route needs N in {MMA_N}, K % 4 == 0 and "
                         f"C % 4 == 0; got N={n}, K={k}, C={c}")
    if splits is not None and splits < 1:
        raise ValueError(f"splits={splits}")
    out = _out(x, w)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the mma route loads 16-byte pieces: x and w must "
                         "be 16-byte aligned")
    if out.numel() == 0:
        return out
    if splits is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        splits = mma_split_k(m, c, k, sms)
    _build.launch(x, _fn("acim_matmul_mma"), "acim_matmul_mma",
                  x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, c, n,
                  b_adc, splits)
    _count("acim_matmul_mma")
    return out
