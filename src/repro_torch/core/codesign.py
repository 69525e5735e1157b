"""Codesign loop: assigned-architecture workloads -> ACIM macro choice.

This closes the loop the paper leaves open: EasyACIM generates Pareto-
optimal macros for a *given array size*, but which point serves a given
model best depends on the model's GEMM structure.  `extract_gemms` pulls
every weight-stationary GEMM out of an ArchConfig (the CIM-mappable set —
see DESIGN.md §9 for what stays digital); `recommend_macro` scores the
explorer's Pareto set under that workload:

  * mapping efficiency: a GEMM with contraction length K runs in
    ceil(K/N) conversions of N = H/L rows; short-K GEMMs waste rows of a
    tall-N macro (utilization = K / (ceil(K/N)*N));
  * columns: out-dim C tiles over W columns (utilization C/(ceil(C/W)*W));
  * effective throughput = T * util; energy/MAC inflates by 1/util;
  * solution score = workload-weighted energy-delay product, subject to a
    user SNR floor (accuracy requirement of the application — the paper's
    Fig. 1 scenario matching, made quantitative).

Counterpart of `repro.core.codesign`.  `recommend_macro` runs the port's
`DesignSession` (on CUDA unless given a device); the scoring of a front
is `score_front`, shared with callers that hold a front already.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import estimator
from repro_torch.core.acim_spec import MacroSpec


@dataclasses.dataclass(frozen=True)
class GemmWorkload:
    name: str
    k: int                  # contraction (dot-product) length
    cols: int               # output columns
    macs_per_token: float   # k * cols * utilization-of-this-gemm per token


def extract_gemms(cfg: ArchConfig) -> list[GemmWorkload]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    l = cfg.n_layers
    gs: list[GemmWorkload] = []

    def add(name, k, cols, mult=1.0):
        gs.append(GemmWorkload(name, int(k), int(cols),
                               float(k) * cols * mult))

    if cfg.family == "ssm":
        x = cfg.xlstm
        inner = int(x.proj_factor * d)
        per = l // 2
        for nm, kk, cc in [("up", d, inner), ("gate", d, inner),
                           ("wq", inner, inner), ("wk", inner, inner),
                           ("wv", inner, inner), ("down", inner, d),
                           ("slstm_gates", d, 4 * d), ("slstm_down", d, d)]:
            add(nm, kk, cc, per)
    elif cfg.family == "hybrid":
        ss = cfg.ssm
        d_inner = ss.expand * d
        add("mamba_in", d, 2 * d_inner + 2 * ss.state + d_inner // ss.head_dim, l)
        add("mamba_out", d_inner, d, l)
        n_attn = l // cfg.hybrid.shared_attn_every
        add("shared_qkvo", d, 4 * d, n_attn)
        add("shared_ffn", d, 3 * cfg.hybrid.shared_ff, n_attn)
    else:
        if cfg.mla is not None:
            m = cfg.mla
            add("wq", d, h * (m.nope_dim + m.rope_dim), l)
            add("w_dkv", d, m.kv_lora, l)
            add("w_uk", m.kv_lora, h * m.nope_dim, l)
            add("w_uv", m.kv_lora, h * m.v_dim, l)
            add("wo", h * m.v_dim, d, l)
        else:
            add("wq", d, h * dh, l)
            add("wk", d, kv * dh, l)
            add("wv", d, kv * dh, l)
            add("wo", h * dh, d, l)
        if cfg.moe is not None:
            m = cfg.moe
            n_mats = 3 if cfg.mlp_gated else 2
            add("experts", d, m.d_ff_expert * n_mats, l * m.top_k)
            if m.n_shared:
                add("shared", d, m.d_ff_expert * m.n_shared * n_mats, l)
            if m.dense_ff:
                add("dense_ffn", d, m.dense_ff * n_mats, l)
        else:
            n_mats = 3 if cfg.mlp_gated else 2
            add("ffn", d, cfg.d_ff * n_mats, l)
    add("lm_head", d, cfg.vocab, 1)
    return gs


def mapping_utilization(spec: MacroSpec, g: GemmWorkload) -> float:
    n = spec.n_caps
    row_u = g.k / (int(np.ceil(g.k / n)) * n)
    col_u = g.cols / (int(np.ceil(g.cols / spec.w)) * spec.w)
    return row_u * col_u


@dataclasses.dataclass(frozen=True)
class Recommendation:
    arch: str
    spec: MacroSpec
    snr_db: float
    eff_tops: float
    eff_tops_per_w: float
    utilization: float
    macro_count_for_rate: int     # macros to sustain 1 token/us decode


def edp_scores(cfg: ArchConfig, res) -> list[tuple[float, float, float, float]]:
    """(utilization, effective TOPS, energy per MAC, energy-delay score)
    of every point of a front (`ParetoResult`) under `cfg`'s workload."""
    gemms = extract_gemms(cfg)
    total_macs = sum(g.macs_per_token for g in gemms)
    out = []
    for i, spec in enumerate(res.specs):
        util = sum(mapping_utilization(spec, g) * g.macs_per_token
                   for g in gemms) / total_macs
        tops = res.metrics["tops"][i] * util
        e = res.metrics["energy_fj_per_mac"][i] / max(util, 1e-9)
        out.append((util, tops, e, e / max(tops, 1e-12)))  # energy-delay proxy
    return out


def score_front(cfg: ArchConfig, res) -> Recommendation:
    """The workload-weighted energy-delay pick of a distilled front
    (`ParetoResult`): the first point of least score."""
    if not len(res):
        raise ValueError("no Pareto point meets the SNR floor")
    scores = edp_scores(cfg, res)
    i = min(range(len(scores)), key=lambda j: scores[j][3])
    util, tops, e, _ = scores[i]
    spec = res.specs[i]
    rate_macs = sum(g.macs_per_token for g in extract_gemms(cfg)) * 1e6
    macro_rate = float(estimator.throughput_ops(spec.h, spec.w, spec.l,
                                                spec.b_adc)) / 2 * util
    return Recommendation(cfg.name, spec, float(res.metrics["snr_db"][i]),
                          float(tops), float(2000.0 / e), float(util),
                          int(np.ceil(rate_macs / macro_rate)))  # 1 tok/us


def recommend_macro(cfg: ArchConfig, *, array_size: int = 65536,
                    min_snr_db: float = 3.0, pop_size: int = 192,
                    generations: int = 50, seed: int = 0,
                    session=None, device=None) -> Recommendation:
    """Score the explorer's Pareto set under the workload.  Pass a
    `repro_torch.api.DesignSession` to share its program/front caches
    across architectures; otherwise one is made on `device` (CUDA when
    None, raising without it)."""
    from repro_torch.api import DesignRequest, DesignSession, Requirements

    req = DesignRequest(array_size=array_size, seed=seed, pop_size=pop_size,
                        generations=generations,
                        requirements=Requirements(min_snr_db=min_snr_db),
                        layout=False)
    if session is None:
        session = DesignSession(device=device)
    return score_front(cfg, session.run(req).pareto)
