"""`ctypes` wrappers of the two flash attention CUDA kernels.

Both replace `repro.kernels.flash_attention.kernel.flash_attention_kernel`
(online-softmax attention, the running max, sum and accumulator in
float32).  They take the model's layout, q (B, S, H, Dh), k (B, T, KV,
Dh) and v (B, T, KV, Dv), and read KV head h // (H // KV) for query head
h by index (the reference's `ops` repeats KV heads in memory instead).

- `flash_attention_wgmma` (`csrc/flash_attention_wgmma.cu`): bf16 at
  the (Dh, Dv) pairs `TC_DIM_PAIRS` (64 / 64, 128 / 128, MLA's 192 /
  128, paligemma's 256 / 256 and zamba2's 80 / 80, whose tiles are
  exactly 80 columns), both products on tensor cores, P rounded to
  bf16, over 128-key tiles (64 at 256 / 256, `ref.tc_kv_tile`); plain
  version `ref.flash_attention_tc_ref`.
- `flash_attention_tf32x3` (`csrc/flash_attention.cu`): float32 at any
  of `HEAD_DIMS`, and bf16 at `TF32X3_BF16_HEAD_DIMS` (Dv = Dh), both
  products on TF32 tensor cores as three products of split operands
  (3xTF32; bf16 inputs need one for S and two for P.V), float32 P;
  plain version `ref.flash_attention_ref`.

`route(dtype, head_dim, v_head_dim)` names the wrapper that `ops.flash_attention`
calls.  For tensors on the CPU a wrapper runs its plain version; for
CUDA tensors it launches its kernel or raises, with no fallback to the
other route.  `flash_attention_wgmma_p` also returns the bf16 P the
tensor-core kernel fed to its P.V, to hold against `ref.flash_attention_tc_p`.
Every launch of either kernel counts in
`repro_torch.kernels.LAUNCHES["flash_attention"]`; the 3xTF32 kernel's
also in `LAUNCHES["flash_attention_tf32x3"]`; the bf16 tensor-core
kernel's also in `LAUNCHES["flash_attention_wgmma"]` and under its
instantiation, `LAUNCHES["flash_attention_wgmma_<Dh>_<Dv>"]` (MLA's
prefill: `flash_attention_wgmma_192_128`; paligemma's
`flash_attention_wgmma_256_256`; zamba2's `flash_attention_wgmma_80_80`).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 128)
TF32X3_BF16_HEAD_DIMS = (16, 32)     # bf16 on the 3xTF32 kernel
TC_HEAD_DIMS = (64, 128)             # tensor cores where v's head dim is q/k's
TC_DIM_PAIRS = tuple((d, d) for d in TC_HEAD_DIMS) + (
    (192, 128),                      # MLA's
    (256, 256),                      # paligemma's (64-key tiles)
    (80, 80))                        # zamba2's (80-column tiles)
ROUTES = (f"routes: bf16 at (q/k, v) head dims {TC_DIM_PAIRS} on tensor "
          f"cores (wgmma); float32 at {HEAD_DIMS}, and bf16 at "
          f"{TF32X3_BF16_HEAD_DIMS}, on TF32 tensor cores (tf32x3)")
DTYPES = (torch.bfloat16, torch.float32)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SHAPE_ARGS = [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
               _I, _I, _I, _I, _I, _I]            # q k v o strides B S T H KV dh
_ARGTYPES = {   # then: [dv,] [bf16,] causal, prefix_len, scale, [p_dump,] stream
    "flash_attention": _SHAPE_ARGS + [_I, _I, _I, ctypes.c_float, _P],
    "flash_attention_wgmma": _SHAPE_ARGS + [_I, _I, _I, ctypes.c_float, _P,
                                            _P]}
_FNS: dict = {}
_FNS_LOCK = threading.Lock()   # first calls may race from several threads


def _fn(name: str):
    """C entry point `name` of `csrc/<name>.cu`, built on first use."""
    with _FNS_LOCK:
        if name not in _FNS:
            fn = getattr(_build.load(name), name)
            fn.argtypes = _ARGTYPES[name]
            fn.restype = _I
            _FNS[name] = fn
        return _FNS[name]


def route(dtype: torch.dtype, head_dim: int,
          v_head_dim: int | None = None) -> str:
    """The kernel that runs attention of this dtype and q/k and v head
    dims (v's defaults to q/k's): "wgmma" (bf16 tensor cores) for bf16 at
    a pair of `TC_DIM_PAIRS`, else "tf32x3" (whose wrapper raises on a
    pair it does not take)."""
    pair = (head_dim, head_dim if v_head_dim is None else v_head_dim)
    if dtype == torch.bfloat16 and pair in TC_DIM_PAIRS:
        return "wgmma"
    return "tf32x3"


def kernel_layout_ok(t: torch.Tensor) -> bool:
    """What both kernels' loads need (16-byte vectors; TMA on the
    bf16 tensor-core route): unit stride on Dh, the other strides multiples
    of 8 elements and not 0 on a dimension of extent > 1 (a tensor map
    takes no zero stride, e.g. of `expand`), a 16-byte aligned pointer."""
    return (t.stride(3) == 1
            and all(st % 8 == 0 and (st != 0 or n == 1)
                    for st, n in zip(t.stride()[:3], t.shape[:3]))
            and t.data_ptr() % 16 == 0)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           prefix_len: int, dim_pairs, dtypes) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q (B, S, H, Dh), k (B, T, KV, Dh), v (B, "
                         f"T, KV, Dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != dh
            or kvh == 0 or h % kvh):
        raise ValueError(f"k must be (B, T, KV, Dh) and v (B, T, KV, Dv) "
                         f"with H % KV == 0; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if (dh, v.shape[3]) not in dim_pairs:
        raise ValueError(f"this flash_attention route takes head dims (q/k, "
                         f"v) {dim_pairs}, not {(dh, v.shape[3])} in "
                         f"{q.dtype}; {ROUTES}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {dtypes}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")


def _launch(name: str, counts: tuple[str, ...], q: torch.Tensor,
            k: torch.Tensor, v: torch.Tensor, tile: int,
            *args) -> torch.Tensor:
    """Launch C entry point `name` on CUDA tensors (layout checks, output,
    strides; `args` follow the head dim in the entry point's order) and
    count the launch under each of `counts`."""
    for nm, x in (("q", q), ("k", k), ("v", v)):
        if not kernel_layout_ok(x):
            raise ValueError(f"{nm}: the kernel needs unit stride on Dh, "
                             f"strides that are multiples of 8 and a 16-byte "
                             f"aligned pointer; got strides {x.stride()} "
                             f"(ops.flash_attention copies such inputs)")
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if -(-s // tile) * b * h >= 2 ** 31:
        raise ValueError(f"grid of {-(-s // tile) * b * h} CTAs is too large")
    out = torch.empty((b, s, h, v.shape[3]), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    _build.launch(q, _fn(name), name, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), strides, b, s, t, h, kvh, dh,
                  *args)
    for c in counts:
        count_launch(c)
    return out


def flash_attention_tf32x3(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           prefix_len: int = 0,
                           block_k: int = ref.KV_TILE) -> torch.Tensor:
    """The 3xTF32 kernel: q: (B, S, H, Dh); k/v: (B, T, KV, Dh); float32
    with Dh in `HEAD_DIMS`, or bf16 with Dh in `TF32X3_BF16_HEAD_DIMS`;
    H % KV == 0.  Returns (B, S, H, Dh) contiguous in q's dtype.
    `block_k` is the plain version's KV block; the kernel streams 32-key
    tiles at Dh 128, 64-key ones below."""
    bf16 = q.dtype == torch.bfloat16
    dims = TF32X3_BF16_HEAD_DIMS if bf16 else HEAD_DIMS
    _check(q, k, v, prefix_len, tuple((d, d) for d in dims), DTYPES)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       prefix_len=prefix_len, block_k=block_k)
    scale = float(np.float32(1.0 / q.shape[3] ** 0.5))
    return _launch("flash_attention",
                   ("flash_attention", "flash_attention_tf32x3"), q, k, v,
                   128, int(bf16), int(causal), prefix_len, scale)


def _tc_counts(q: torch.Tensor, v: torch.Tensor) -> tuple[str, ...]:
    """The launch counts a tensor-core launch adds to: both routes', the
    tensor-core kernel's and its (Dh, Dv) instantiation's."""
    return ("flash_attention", "flash_attention_wgmma",
            f"flash_attention_wgmma_{q.shape[3]}_{v.shape[3]}")


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, prefix_len: int = 0,
                          block_k: int | None = None) -> torch.Tensor:
    """The tensor-core kernel: q: (B, S, H, Dh); k: (B, T, KV, Dh); v:
    (B, T, KV, Dv); bf16; H % KV == 0; (Dh, Dv) in `TC_DIM_PAIRS`.
    Returns (B, S, H, Dv) contiguous bf16.  `block_k` is the plain
    version's KV block (default: the kernel's tile, `ref.tc_kv_tile`: 128
    keys, 64 at 256 / 256)."""
    _check(q, k, v, prefix_len, TC_DIM_PAIRS, (torch.bfloat16,))
    if q.device.type == "cpu":
        return ref.flash_attention_tc_ref(q, k, v, causal=causal,
                                          prefix_len=prefix_len,
                                          block_k=block_k)
    return _launch("flash_attention_wgmma", _tc_counts(q, v), q, k, v, 128,
                   v.shape[3], int(causal), prefix_len,
                   # lint: disable=host-guard -- a host scalar, not a fallback
                   ref.score_scale_log2(q.shape[3]), None)


def flash_attention_wgmma_p(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            prefix_len: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention_wgmma` that also returns the bf16 P its kernel
    fed to P.V, (B, H, S, T), laid out as `ref.flash_attention_tc_p`
    (on the CPU: that function's).  For checking the kernel's arithmetic
    only: the P is B * H * S * T * 2 bytes."""
    _check(q, k, v, prefix_len, TC_DIM_PAIRS, (torch.bfloat16,))
    if q.device.type == "cpu":
        kw = dict(causal=causal, prefix_len=prefix_len)
        return (ref.flash_attention_tc_ref(q, k, v, **kw),
                ref.flash_attention_tc_p(q, k, v, **kw))
    p = torch.zeros((q.shape[0], q.shape[2], q.shape[1], k.shape[1]),
                    dtype=torch.bfloat16, device=q.device)
    out = _launch("flash_attention_wgmma", _tc_counts(q, v), q, k, v, 128,
                  v.shape[3], int(causal), prefix_len,
                  # lint: disable=host-guard -- a host scalar, not a fallback
                  ref.score_scale_log2(q.shape[3]), p.data_ptr())
    return out, p
