"""GQA / MQA / MHA attention (+bias, +qk_norm): the full-sequence forward
of training and prefill, dense (`attention_fwd`) and blockwise
(`attention_fwd_blockwise`, the long-context prefill path), and the
one-token decode over a KV cache (`init_kv_cache`, `attention_decode`).

Counterpart of the GQA part of `repro.models.attention`.  Shapes follow
(B, S, H, Dh).  The blockwise forward runs through the flash attention
kernel (`repro_torch.kernels.flash_attention`); `_blockwise_core` is the
plain PyTorch form of the reference's jnp online softmax.  The
reference's sharding annotations (`logical`) have no counterpart here;
MLA is not ported.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common
from repro_torch.models.common import NEG_INF, apply_rope, dense_init


class Attention(nn.Module):
    """Projection weights `wq`, `wk`, `wv` (D, H*Dh) and `wo` (H*Dh, D);
    optional biases `bq`, `bk`, `bv` and per-head `q_norm` / `k_norm`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        dh = cfg.resolved_head_dim
        self.wq = nn.Parameter(dense_init(generator, (d, h * dh)))
        self.wk = nn.Parameter(dense_init(generator, (d, kv * dh)))
        self.wv = nn.Parameter(dense_init(generator, (d, kv * dh)))
        self.wo = nn.Parameter(dense_init(generator, (h * dh, d)))
        if cfg.attn_bias:
            self.bq = nn.Parameter(torch.zeros(h * dh))
            self.bk = nn.Parameter(torch.zeros(kv * dh))
            self.bv = nn.Parameter(torch.zeros(kv * dh))
        if cfg.qk_norm:
            self.q_norm = common.init_norm(dh, "rmsnorm")
            self.k_norm = common.init_norm(dh, "rmsnorm")


def init_attention(cfg: ArchConfig, generator: torch.Generator) -> Attention:
    return Attention(cfg, generator)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if cfg.attn_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = common.rmsnorm(p.q_norm.scale, q)
        k = common.rmsnorm(p.k_norm.scale, k)
    if cfg.pos == "rope":
        q = apply_rope(q.transpose(1, 2), positions,
                       cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), positions,
                       cfg.rope_theta).transpose(1, 2)
    return q, k, v


def attention_fwd(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                  mask: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention.  mask: (S, T) bool (True = attend).

    Scores leave the einsum in x's dtype and are scaled in float32 (the
    reference divides by a float32 scalar, which promotes); softmax runs
    in float32 and its probabilities go back to x's dtype."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    q, k, v = _project_qkv(p, x, cfg, positions)
    qg = q.reshape(b, s, kv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    scores = scores / float(np.float32(np.sqrt(dh)))
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(b, s, h * dh)
    return out @ p.wo.to(x.dtype)


def attention_fwd_blockwise(p: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                            positions: torch.Tensor, kv_block: int = 1024,
                            prefix_len: int = 0) -> torch.Tensor:
    """Flash-style online-softmax attention over KV blocks: never holds
    the (S, S) score matrix, for the 32k+ prefill shapes.  Mask: causal,
    plus bidirectional over the first `prefix_len` positions.

    Runs `flash_attention` (a CUDA kernel on the card, its plain version
    on the CPU), which computes the scores and the softmax statistics in
    float32 from x's dtype and rounds the output once; in bf16 at head
    dims 64 and 128 (qwen2.5-3b's 128) it takes the tensor-core route,
    which rounds P to bf16 before P.V as the reference's jnp core
    (`_blockwise_core`) does; the core also rounds the scores and P.V to
    x's dtype.  `kv_block` is the plain version's KV block; the kernels
    stream 64-key (CUDA cores) or 128-key (tensor cores) tiles."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = flash_ops.flash_attention(q, k, v, causal=True,
                                    prefix_len=prefix_len, block_k=kv_block)
    return out.reshape(b, s, h * dh) @ p.wo.to(x.dtype)


def _blockwise_core(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_block: int, prefix_len: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """qg: (B,S,KV,G,Dh); k/v: (B,T,KV,Dh).  Returns (B,S,KV,G,Dh).

    The reference's jnp online softmax, op for op: scores and P.V leave
    their einsums in qg's dtype, the scores are scaled in float32 (the
    reference multiplies by a float64 NumPy scalar, which promotes), the
    running (max, sum, acc) are float32."""
    b, s, kvh, g, dh = qg.shape
    t = k.shape[1]
    kv_block = min(kv_block, t)
    while t % kv_block:           # e.g. 32768 + 256 patches -> block 256
        kv_block //= 2
    scale = float(np.float32(1.0 / np.sqrt(dh)))
    q_idx = torch.arange(s, device=qg.device)
    acc = torch.zeros((b, s, kvh, g, dh), dtype=torch.float32,
                      device=qg.device)
    m = torch.full((b, s, kvh, g), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros((b, s, kvh, g), dtype=torch.float32, device=qg.device)
    for j0 in range(0, t, kv_block):
        kj, vj = k[:, j0:j0 + kv_block], v[:, j0:j0 + kv_block]
        k_idx = j0 + torch.arange(kv_block, device=qg.device)
        mask = (k_idx[None, :] <= q_idx[:, None]) | (
            (q_idx[:, None] < prefix_len) & (k_idx[None, :] < prefix_len))
        sc = torch.einsum("bskgd,btkd->bskgt", qg, kj).to(torch.float32)
        sc = torch.where(mask[None, :, None, None, :], sc * scale, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p_ = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p_.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bskgt,btkd->bskgd", p_.to(qg.dtype), vj).to(torch.float32)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(out_dtype)


def init_kv_cache(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Zeroed k / v caches, each (B, KV, S, Dh), on `device` (None: the
    card; raises without one)."""
    device = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p: Attention, x_t: torch.Tensor, cache: dict, pos: int,
                     cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x_t: (B, D); cache k / v: (B, KV, S, Dh); pos:
    the token's position.

    The token's k and v are written into the cache in place at `pos`.
    Scores leave the einsum in x's dtype and are scaled in float32 (the
    reference divides by a NumPy float64 scalar, float32 without x64);
    positions past `pos` are masked with `NEG_INF` in float32, and the
    float32 softmax goes back to x's dtype for P.V."""
    b, _ = x_t.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    positions = torch.full((1,), pos, dtype=torch.int32, device=x_t.device)
    q, k, v = _project_qkv(p, x_t[:, None, :], cfg, positions)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, :, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v[:, 0].to(v_cache.dtype)
    qh = q[:, 0].reshape(b, kv, g, dh)
    scores = torch.einsum("bkgd,bktd->bkgt", qh,
                          k_cache.to(qh.dtype)).to(torch.float32)
    scores = scores / float(np.float32(np.sqrt(dh)))
    valid = torch.arange(k_cache.shape[2], device=x_t.device) <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x_t.dtype)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v_cache.to(probs.dtype))
    return out.reshape(b, h * dh) @ p.wo.to(x_t.dtype), cache
