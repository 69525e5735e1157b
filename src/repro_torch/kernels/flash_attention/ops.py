"""Public flash attention entry point: bring q, k, v to a layout the
kernels read (unit stride on Dh, strides that are multiples of 8 and not
0, an aligned pointer; other inputs are copied) and call the wrapper of
the route `kernel.route` names (bf16 at q/k and v head dims 64 / 64, 128 /
128, MLA's 192 / 128, paligemma's 256 / 256 and zamba2's 80 / 80 on
bf16 tensor cores, float32 and bf16 at 16 / 32 on TF32 tensor cores as
3xTF32; a pair neither route takes raises).  KV heads are not
repeated: the kernels map query head h to KV head h // (H // KV).  Tail
tiles are masked in the kernels, so nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cuda" or t.dim() != 4 or kernel.kernel_layout_ok(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0,
                    block_k: int | None = None) -> torch.Tensor:
    """q: (B, S, H, Dh); k: (B, T, KV, Dh); v: (B, T, KV, Dv) with H % KV
    == 0 (Dv differs from Dh only on the tensor-core route).

    Returns (B, S, H, Dv) in q's dtype: softmax(q k^T / sqrt(Dh)) v under
    the causal mask (bidirectional over the first `prefix_len`
    positions), or no mask when not causal, with float32 scores and
    softmax statistics (P rounded to bf16 before P.V on the tensor-core
    route).  `block_k` is the KV block of the plain version (CPU
    tensors; default: the route's kernel tile, on tensor cores the
    instantiation's, `ref.tc_kv_tile`)."""
    q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    if kernel.route(q.dtype, q.shape[-1], v.shape[-1]) == "wgmma":
        return kernel.flash_attention_wgmma(
            q, k, v, causal=causal, prefix_len=prefix_len, block_k=block_k)
    return kernel.flash_attention_tf32x3(
        q, k, v, causal=causal, prefix_len=prefix_len,
        block_k=block_k or ref.KV_TILE)
