"""Attention mixers: GQA / MQA / MHA (+bias, +qk_norm) and DeepSeek's
MLA.  Each has a full-sequence forward of training and prefill, dense
(`attention_fwd`, `mla_fwd`) and blockwise (`attention_fwd_blockwise`,
`mla_fwd_blockwise`, the long-context prefill path), and a one-token
decode over a cache (`init_kv_cache` / `attention_decode`;
`init_mla_cache` / `mla_decode`, the absorbed form over the compressed
latent).

Counterpart of `repro.models.attention`.  Shapes follow (B, S, H, Dh).
The blockwise forwards run through the flash attention kernel
(`repro_torch.kernels.flash_attention`; MLA at q/k head dim nope + rope
and v head dim v_dim, 192 and 128 for deepseek-v2-lite);
`_blockwise_core` is the plain PyTorch form of the reference's jnp
online softmax.  The reference's sharding annotations (`logical`) have
no counterpart here.
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed-KV latent attention, decoupled RoPE
# ---------------------------------------------------------------------------
class MLA(nn.Module):
    """`wq` (D, H*(nope+rope)), the KV down-projection `w_dkv` (D,
    kv_lora) with its `kv_norm`, the shared rope key `w_kr` (D, rope),
    the up-projections `w_uk` (kv_lora, H*nope) and `w_uv` (kv_lora,
    H*v), and `wo` (H*v, D)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        self.wq = nn.Parameter(dense_init(generator,
                                          (d, h * (m.nope_dim + m.rope_dim))))
        self.w_dkv = nn.Parameter(dense_init(generator, (d, m.kv_lora)))
        self.w_kr = nn.Parameter(dense_init(generator, (d, m.rope_dim)))
        self.kv_norm = common.init_norm(m.kv_lora, "rmsnorm")
        self.w_uk = nn.Parameter(dense_init(generator,
                                            (m.kv_lora, h * m.nope_dim)))
        self.w_uv = nn.Parameter(dense_init(generator,
                                            (m.kv_lora, h * m.v_dim)))
        self.wo = nn.Parameter(dense_init(generator, (h * m.v_dim, d)))


def init_mla(cfg: ArchConfig, generator: torch.Generator) -> MLA:
    return MLA(cfg, generator)


def _mla_scale(cfg: ArchConfig) -> float:
    """1 / sqrt(nope + rope) in float32 (a NumPy float64 scalar in the
    reference, float32 without x64; it promotes bf16 scores)."""
    m = cfg.mla
    return float(np.float32(1.0 / np.sqrt(m.nope_dim + m.rope_dim)))


def _mla_q(p: MLA, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor):
    m = cfg.mla
    b, s, _ = x.shape
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, cfg.n_heads,
                                       m.nope_dim + m.rope_dim)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions,
                        cfg.rope_theta).transpose(1, 2)
    return q_nope, q_rope


def _mla_kv(p: MLA, x: torch.Tensor, cfg: ArchConfig,
            positions: torch.Tensor):
    """(k_nope (B, S, H, nope), v (B, S, H, v), k_rope (B, S, rope)): the
    latent's up-projections and the shared rope key."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    c = common.rmsnorm(p.kv_norm.scale, x @ p.w_dkv.to(x.dtype))
    k_nope = (c @ p.w_uk.to(x.dtype)).reshape(b, s, h, m.nope_dim)
    v = (c @ p.w_uv.to(x.dtype)).reshape(b, s, h, m.v_dim)
    k_rope = apply_rope(x @ p.w_kr.to(x.dtype), positions, cfg.rope_theta)
    return k_nope, v, k_rope


def mla_fwd(p: MLA, x: torch.Tensor, cfg: ArchConfig, *, mask: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA with per-head keys from the latent.  mask: (S, T)
    bool.  The nope and rope scores leave their einsums in x's dtype and
    are summed there, then scaled in float32; softmax in float32, its
    probabilities back to x's dtype for P.V."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    k_nope, v, k_rope = _mla_kv(p, x, cfg, positions)
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btd->bhst", q_rope, k_rope))
    scores = scores.to(torch.float32) * _mla_scale(cfg)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(
        b, s, cfg.n_heads * m.v_dim)
    return out @ p.wo.to(x.dtype)


def mla_fwd_blockwise(p: MLA, x: torch.Tensor, cfg: ArchConfig, *,
                      positions: torch.Tensor,
                      kv_block: int = 1024) -> torch.Tensor:
    """Blockwise MLA prefill by expansion to per-head keys: q' = [q_nope,
    q_rope], k' = [k_nope, k_rope broadcast over heads], both at head dim
    nope + rope, and v at v_dim, through `flash_attention` (causal; its
    scale 1 / sqrt(nope + rope) is MLA's).  The reference pads v to
    k's head dim to reuse its jnp core and slices the padding off; the
    kernel reduces q/k and v at their own head dims (192 and 128 for
    deepseek-v2-lite: the tensor-core instantiation), which gives the
    same numbers, the padded columns being zeros."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    k_nope, v, k_rope = _mla_kv(p, x, cfg, positions)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.rope_dim)],
                  -1)
    out = flash_ops.flash_attention(q, k, v, causal=True, block_k=kv_block)
    return out.reshape(b, s, h * m.v_dim) @ p.wo.to(x.dtype)


def init_mla_cache(cfg: ArchConfig, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Zeroed latent cache `c_kv` (B, S, kv_lora) and shared rope key
    cache `k_rope` (B, S, rope) on `device` (None: the card; raises
    without one)."""
    device = resolve_device(device)
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_seq, m.kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_seq, m.rope_dim), dtype=dtype,
                                  device=device)}


def mla_decode(p: MLA, x_t: torch.Tensor, cache: dict, pos: int,
               cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """Absorbed MLA decode: scores and values work in the latent.

    q_abs[b,h,c] = sum_d q_nope[b,h,d] w_uk[c, h*d];
    score[t] = (q_abs . c_kv[t] + q_rope . k_rope[t]) * scale;
    out_h = (sum_t p[t] c_kv[t]) @ W_uv_h.  The token's latent and rope
    key are written into the cache in place at `pos`."""
    m = cfg.mla
    b, _ = x_t.shape
    h = cfg.n_heads
    x = x_t[:, None, :]
    posv = torch.full((1,), pos, dtype=torch.int32, device=x_t.device)
    q_nope, q_rope = _mla_q(p, x, cfg, posv)
    c_t = common.rmsnorm(p.kv_norm.scale, x @ p.w_dkv.to(x.dtype))[:, 0]
    kr_t = apply_rope(x @ p.w_kr.to(x.dtype), posv, cfg.rope_theta)[:, 0]
    c_cache, kr_cache = cache["c_kv"], cache["k_rope"]
    c_cache[:, pos] = c_t.to(c_cache.dtype)
    kr_cache[:, pos] = kr_t.to(kr_cache.dtype)
    w_uk = p.w_uk.to(x_t.dtype).reshape(m.kv_lora, h, m.nope_dim)
    q_abs = torch.einsum("bhd,chd->bhc", q_nope[:, 0], w_uk)
    scores = (torch.einsum("bhc,btc->bht", q_abs, c_cache.to(q_abs.dtype))
              + torch.einsum("bhd,btd->bht", q_rope[:, 0],
                             kr_cache.to(q_rope.dtype)))
    scores = scores.to(torch.float32) * _mla_scale(cfg)
    valid = torch.arange(c_cache.shape[1], device=x_t.device) <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x_t.dtype)
    out_lat = torch.einsum("bht,btc->bhc", probs, c_cache.to(probs.dtype))
    w_uv = p.w_uv.to(x_t.dtype).reshape(m.kv_lora, h, m.v_dim)
    out = torch.einsum("bhc,chd->bhd", out_lat, w_uv).reshape(b, h * m.v_dim)
    return out @ p.wo.to(x_t.dtype), cache
