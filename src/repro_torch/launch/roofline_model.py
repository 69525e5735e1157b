"""Analytic FLOP / HBM-byte model per (arch x shape) cell.

Counterpart of `repro.launch.roofline_model`, term for term: the
reference records these analytic terms beside XLA's cost analysis
(which counts each `while` body once); the port has no XLA, so its
dry-run (`launch/dryrun.py`) reads only these.

Conventions (global, per step):
  train FLOPs  = (2 fwd + 2 recompute-under-remat/3 + 4 bwd) matmul flops
                 = 6 * N_mat * T * remat_factor(4/3)  + attention/SSD terms
  N_mat        = matmul parameters (active for MoE; embedding lookup and
                 positional tables excluded, LM head included)
  attention    = 6 * L * B * S^2 * H * dh * (0.5 causal) * remat_factor
  bytes        = parameter traffic (fwd/bwd/recompute reads per microbatch
                 + optimizer read/write) + activation traffic
                 (~8 bytes/elem/layer heuristic for read+write over
                 norm/attn/mlp internals) + dense-score traffic.

The parameter counts are the port's (`models.registry.count_params`:
per-layer leaves, the same integers as the reference's stacked ones).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.shapes import ShapeSpec, microbatches_for
from repro_torch.models.mlp import moe_capacity
from repro_torch.models.registry import count_params, embedding_params


@dataclasses.dataclass(frozen=True)
class CellCost:
    flops: float              # global per step
    hbm_bytes: float          # global per step
    notes: str = ""


def matmul_params(cfg: ArchConfig, active: bool = True) -> float:
    return count_params(cfg, active_only=active and cfg.moe is not None) \
        - embedding_params(cfg) + cfg.vocab * cfg.d_model  # head back in


def _attn_flops_fwd(cfg: ArchConfig, b: int, s: int, causal: bool = True) -> float:
    l = cfg.n_layers  # noqa: E741
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    per = 4.0 * b * s * s * h * dh * (0.5 if causal else 1.0)
    if cfg.family == "hybrid":
        # only the shared block attends, once per group
        n_attn = cfg.n_layers // cfg.hybrid.shared_attn_every
        return per / l * n_attn if l else 0.0
    if cfg.family == "ssm":
        return 0.0
    if cfg.family == "audio":
        f = cfg.encdec.enc_frames
        enc = 4.0 * b * f * f * h * dh * cfg.encdec.n_enc_layers
        dec_self = per * 1.0
        cross = 4.0 * b * s * f * h * dh * cfg.n_layers
        return enc + dec_self + cross
    return per * l


def _ssd_flops_fwd(cfg: ArchConfig, b: int, s: int) -> float:
    if cfg.family == "hybrid":
        ss = cfg.ssm
        d_inner = ss.expand * cfg.d_model
        nh = d_inner // ss.head_dim
        ch = min(ss.chunk, s)
        # intra-chunk quasi-attention + inter-chunk state products
        intra = 4.0 * b * s * ch * nh * (ss.state + ss.head_dim)
        inter = 4.0 * b * s * nh * ss.state * ss.head_dim
        return (intra + inter) * cfg.n_layers
    if cfg.family == "ssm":
        x = cfg.xlstm
        inner = int(x.proj_factor * cfg.d_model)
        nh = cfg.n_heads
        dh = inner // nh
        ch = x.chunk
        n_pairs = cfg.n_layers // 2
        mlstm = (4.0 * b * s * ch * nh * dh          # intra scores+values
                 + 4.0 * b * s * nh * dh * dh)       # state in/out products
        slstm = 8.0 * b * s * nh * dh * dh           # recurrent gate matmuls
        return (mlstm + slstm) * n_pairs
    return 0.0


def _moe_dispatch_flops_fwd(cfg: ArchConfig, t: float) -> float:
    if cfg.moe is None:
        return 0.0
    m = cfg.moe
    c = moe_capacity(m)
    return 4.0 * t * m.n_experts * c * cfg.d_model * cfg.n_layers \
        / max(m.group_size / min(m.group_size, t), 1)


def train_cost(cfg: ArchConfig, shape: ShapeSpec) -> CellCost:
    b, s = shape.batch, shape.seq
    t = float(b * s)
    nm = matmul_params(cfg)
    remat = 4.0 / 3.0
    fwd = 2.0 * nm * t + _attn_flops_fwd(cfg, b, s) + _ssd_flops_fwd(cfg, b, s) \
        + _moe_dispatch_flops_fwd(cfg, t)
    flops = 3.0 * fwd * remat

    mb = microbatches_for(cfg, shape)
    p_total = count_params(cfg)        # stored params (all experts)
    p_bytes = 4.0                      # f32 master
    opt_bytes = 16.0                   # m,v read+write (f32) avg
    # per microbatch: fwd read + bwd read + remat re-read of weights
    w_traffic = p_total * p_bytes * 3.0 * mb + p_total * (opt_bytes + 2 * p_bytes)
    act_traffic = cfg.n_layers * t * cfg.d_model * 2.0 * 8.0
    score_traffic = 0.0
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        # dense-materialized fp32 scores read+write, fwd+bwd (baseline impl)
        score_traffic = 2.0 * b * s * s * cfg.n_heads * 4.0 * 2.0
    return CellCost(flops, w_traffic + act_traffic + score_traffic)


def prefill_cost(cfg: ArchConfig, shape: ShapeSpec) -> CellCost:
    b, s = shape.batch, shape.seq
    t = float(b * s)
    nm = matmul_params(cfg)
    flops = 2.0 * nm * t + _attn_flops_fwd(cfg, b, s) \
        + _ssd_flops_fwd(cfg, b, s) + _moe_dispatch_flops_fwd(cfg, t)
    w = count_params(cfg) * 2.0        # bf16 serving weights, read once
    act = cfg.n_layers * t * cfg.d_model * 2.0 * 6.0
    return CellCost(flops, w + act)


def decode_cost(cfg: ArchConfig, shape: ShapeSpec) -> CellCost:
    b, s = shape.batch, shape.seq
    nm = matmul_params(cfg)
    flops = 2.0 * nm * b
    # attention over the cache (linear per token)
    h, dh, kv = cfg.n_heads, cfg.resolved_head_dim, cfg.n_kv_heads
    cache_bytes = 0.0
    if cfg.family in ("dense", "moe", "vlm"):
        if cfg.mla is not None:
            m = cfg.mla
            flops += 4.0 * b * s * h * (m.kv_lora + m.rope_dim) * cfg.n_layers
            cache_bytes = b * s * (m.kv_lora + m.rope_dim) * 2.0 * cfg.n_layers
        else:
            flops += 4.0 * b * s * h * dh * cfg.n_layers
            cache_bytes = 2.0 * b * s * kv * dh * 2.0 * cfg.n_layers
    if cfg.family == "audio":
        f = cfg.encdec.enc_frames
        flops += (4.0 * b * s * h * dh + 4.0 * b * f * h * dh) * cfg.n_layers
        cache_bytes = (2.0 * b * s * kv * dh + 2.0 * b * f * h * dh) * 2.0 \
            * cfg.n_layers
    if cfg.family == "hybrid":
        hy = cfg.hybrid
        n_attn = cfg.n_layers // hy.shared_attn_every
        flops += 4.0 * b * s * hy.attn_heads * (cfg.d_model // hy.attn_heads) \
            * n_attn
        ss = cfg.ssm
        d_inner = ss.expand * cfg.d_model
        nh = d_inner // ss.head_dim
        state = b * nh * ss.state * ss.head_dim * 4.0 * cfg.n_layers
        cache_bytes = 2.0 * b * s * hy.attn_kv_heads * (
            cfg.d_model // hy.attn_heads) * 2.0 * n_attn + 2.0 * state
        flops += 6.0 * b * nh * ss.state * ss.head_dim * cfg.n_layers
    if cfg.family == "ssm":
        x = cfg.xlstm
        inner = int(x.proj_factor * cfg.d_model)
        nh = cfg.n_heads
        dh_i = inner // nh
        n_pairs = cfg.n_layers // 2
        flops += (6.0 * b * nh * dh_i * dh_i + 8.0 * b * nh * dh_i * dh_i) \
            * n_pairs
        cache_bytes = 2.0 * b * nh * dh_i * dh_i * 4.0 * n_pairs
    weights = count_params(cfg) * 2.0          # bf16, read once per token
    return CellCost(flops, weights + cache_bytes + b * cfg.n_layers
                    * cfg.d_model * 2.0 * 6.0)


def cell_cost(cfg: ArchConfig, shape: ShapeSpec) -> CellCost:
    if shape.kind == "train":
        return train_cost(cfg, shape)
    if shape.kind == "prefill":
        return prefill_cost(cfg, shape)
    return decode_cost(cfg, shape)
