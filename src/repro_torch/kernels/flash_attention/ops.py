"""Public flash attention entry point: bring q, k, v to a layout the
kernel reads (unit stride on Dh, strides that are multiples of 8, an
aligned pointer; other inputs are copied) and call the wrapper.  KV heads
are not repeated: the kernel maps query head h to KV head h // (H // KV).
Tail tiles are masked in the kernel, so nothing is padded.
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
                    block_k: int = ref.KV_TILE) -> torch.Tensor:
    """q: (B, S, H, Dh); k/v: (B, T, KV, Dh) with H % KV == 0.

    Returns (B, S, H, Dh) in q's dtype: softmax(q k^T / sqrt(Dh)) v under
    the causal mask (bidirectional over the first `prefix_len`
    positions), or no mask when not causal, computed in float32.
    `block_k` is the KV block of the plain version (CPU tensors)."""
    return kernel.flash_attention(_kernel_layout(q), _kernel_layout(k),
                                  _kernel_layout(v), causal=causal,
                                  prefix_len=prefix_len, block_k=block_k)
