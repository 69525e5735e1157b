"""GQA / MQA / MHA attention (+bias, +qk_norm): the full-sequence forward
of training and prefill.

Counterpart of the GQA part of `repro.models.attention`.  Shapes follow
(B, S, H, Dh).  The reference's sharding annotations (`logical`) have no
counterpart here; MLA, the blockwise forward and decode are not ported.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
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
