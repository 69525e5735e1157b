"""Mamba2 mixer (SSD — state-space duality), chunked-parallel + decode step.

Counterpart of `repro.models.mamba2`.  Prefill and training use the
chunkwise SSD algorithm: within a chunk the output is a masked
(quasi-causal) attention-like product; across chunks a small recurrence
over per-chunk states runs in float32, a Python loop over the chunks.
Decode is the exact O(1) recurrent update.  The reference computes all
of it with jnp outside any Pallas kernel, so this is PyTorch and cuBLAS;
its sharding annotations (`logical`) have no counterpart here.

Shapes: x (B, S, D) -> inner D_i = expand*D split into H = D_i/P heads of
dim P, with per-head scalar decay a_t = exp(-softplus(dt) * A) and
(grouped) B/C projections of state size N.  Every product and sum runs
in x's dtype as the reference's does, the decays and the chunk
recurrence in float32, with the reference's casts between them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import _draw_device, dense_init, init_norm


def dims(cfg: ArchConfig) -> tuple[int, int]:
    """(d_inner, n_heads)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


class Mamba2(nn.Module):
    """`in_proj` (D, 2 D_i + 2 G N + H) packing [x_path, z_gate, B, C,
    dt]; the depthwise causal conv `conv_w` (K, D_i + 2 G N) and `conv_b`;
    per-head `a_log`, `dt_bias` and `d_skip`; the gated RMSNorm `norm`
    (D_i) and `out_proj` (D_i, D).  Drawn from `generator`: `in_proj`,
    `conv_w` (0.1 x standard normal), `out_proj`; the rest as the
    reference sets them."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_inner, nh = dims(cfg)
        d_bc = 2 * s.n_groups * s.state
        self.in_proj = nn.Parameter(dense_init(
            generator, (d, 2 * d_inner + d_bc + nh)))
        self.conv_w = nn.Parameter(0.1 * torch.randn(
            (s.conv_width, d_inner + d_bc), generator=generator,
            device=_draw_device(generator)))
        self.conv_b = nn.Parameter(torch.zeros(d_inner + d_bc))
        self.a_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, nh)))
        self.dt_bias = nn.Parameter(torch.full(
            (nh,), float(np.float32(np.log(np.expm1(0.01))))))
        self.d_skip = nn.Parameter(torch.ones(nh))
        self.norm = init_norm(d_inner, "rmsnorm")
        self.out_proj = nn.Parameter(dense_init(generator, (d_inner, d)))


def init_mamba2(cfg: ArchConfig, generator: torch.Generator) -> Mamba2:
    return Mamba2(cfg, generator)


def _split_proj(proj: torch.Tensor, cfg: ArchConfig, nh: int | None = None):
    """proj (..., 2 D_i + 2 G N + H) -> (x_in, z, B, C, dt), views; `nh`
    heads (default the config's: a tensor-parallel position passes its
    own, D_i then nh x head dim)."""
    s = cfg.ssm
    nh = dims(cfg)[1] if nh is None else nh
    d_inner = nh * s.head_dim
    gn = s.n_groups * s.state
    return torch.split(proj, (d_inner, d_inner, gn, gn, nh), dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


# the gated RMSNorm's epsilon
NORM_EPS = 1e-6


def _gated_rmsnorm(p: nn.Module, x: torch.Tensor, z: torch.Tensor,
                   eps: float = NORM_EPS) -> torch.Tensor:
    xf = (x * F.silu(z)).to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p.scale).to(x.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time.  x (B, S, C), w (K, C): the K
    shifted products summed in x's dtype in the reference's order."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    return out + b


def _grouped(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, N, H, ...) -> (B, N, G, H / G, ...): heads under their B/C
    group (`jnp.repeat`'s order: group g holds heads g H/G onward)."""
    return t.view(t.shape[:2] + (groups, t.shape[2] // groups) + t.shape[3:])


def _ssd_intra(cum: torch.Tensor, cg: torch.Tensor, bg: torch.Tensor,
               xc: torch.Tensor) -> torch.Tensor:
    """Within each chunk: y_t = sum_{u <= t} (C_t . B_u) exp(cum_t -
    cum_u) x_u, (B, N, H, ch, P) in x's dtype.  cum (B, N, H, ch) float32;
    cg / bg (B, N, G, ch, state); xc (B, N, H, ch, P).  The decay is
    float32 (exp(-inf) = 0 off the causal triangle, as the reference's
    `where`), cast to x's dtype before it scales C B^T."""
    ch, ng = cum.shape[-1], cg.shape[2]
    mask = torch.tril(torch.ones((ch, ch), dtype=torch.bool,
                                 device=cum.device))
    decay = torch.where(mask, cum[..., :, None] - cum[..., None, :],
                        -torch.inf).exp().to(xc.dtype)      # (B,N,H,t,u)
    cb = cg @ bg.transpose(-1, -2)                              # (B,N,G,t,u)
    scores = _grouped(decay, ng) * cb[:, :, :, None]
    del decay, cb
    return scores.view(cum.shape + (ch,)) @ xc


def _chunk_states(cum: torch.Tensor, bg: torch.Tensor,
                  xc: torch.Tensor) -> torch.Tensor:
    """Each chunk's input -> state contribution sum_t B_t exp(cum_last -
    cum_t) x_t, (B, N, H, state, P) in x's dtype."""
    ng = bg.shape[2]
    decay_in = torch.exp(cum[..., -1:] - cum).to(xc.dtype)      # (B,N,H,ch)
    st = bg.transpose(-1, -2)[:, :, :, None] @ _grouped(
        decay_in[..., None] * xc, ng)
    return st.view(xc.shape[:3] + st.shape[-2:])


def _chunk_recurrence(state_in: torch.Tensor,
                      seg_total: torch.Tensor) -> torch.Tensor:
    """The state entering each chunk, (B, N, H, state, P) in state_in's
    dtype: h_0 = 0, h_{n+1} = h_n exp(seg_n) + state_in_n, carried in
    float32 across the chunks (a loop over N) and cast once per chunk,
    as the reference's `lax.scan`."""
    st_seq = state_in.to(torch.float32)
    h = torch.zeros(st_seq[:, 0].shape, dtype=torch.float32,
                    device=state_in.device)
    h_prev = torch.empty_like(state_in)
    seg_exp = torch.exp(seg_total)                              # (B,N,H)
    for n in range(state_in.shape[1]):
        h_prev[:, n] = h
        h = h * seg_exp[:, n, :, None, None] + st_seq[:, n]
    return h_prev


def _ssd_inter(cum: torch.Tensor, cg: torch.Tensor,
               h_prev: torch.Tensor) -> torch.Tensor:
    """Across chunks: y_t = exp(cum_t) C_t . h_prev, (B, N, H, ch, P) in
    h_prev's dtype."""
    ng = cg.shape[2]
    decay_out = torch.exp(cum).to(h_prev.dtype)                 # (B,N,H,ch)
    y = cg[:, :, :, None] @ _grouped(h_prev, ng)
    return decay_out[..., None] * y.view(cum.shape + y.shape[-1:])


def mamba2_fwd(p: Mamba2, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Chunked SSD forward.  x: (B, S, D) with S % min(chunk, S) == 0
    (raises `ValueError` otherwise).  Returns (B, S, D) in x's dtype:
    `mamba2_mix`, the gated RMSNorm over D_i and `out_proj`."""
    y, z = mamba2_mix(p, x, cfg)
    y = _gated_rmsnorm(p.norm, y, z)
    return y @ p.out_proj.to(x.dtype)


def mamba2_mix(p: Mamba2, x: torch.Tensor,
               cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The mixer up to its gated norm: (y, z), each (B, S, H P) in x's
    dtype, the SSD output with its skip term and the gate.  The heads
    are the weights' (H = `a_log`'s length), so the same code runs a
    tensor-parallel position's heads (`parallel.tensor_parallel`: its
    x, z and dt columns of `in_proj` with the whole B and C) as it runs
    the whole mixer.

    Memory: the intra-chunk decay and scores are (B, S/ch, H, ch, ch),
    2.68 GB in float32 and 1.34 GB in bf16 at zamba2-2.7b's 1 x 32768
    (80 heads, chunk 256).  At most two float32 and two x-dtype tensors
    of that size live at once, each let go as soon as it is used.
    With one B/C group (zamba2's) C B^T is computed once a group and
    broadcast over its heads: the same dot products as the reference's
    per-head einsum."""
    s = cfg.ssm
    bsz, seq, _ = x.shape
    nh = p.a_log.shape[0]
    d_inner = nh * s.head_dim
    ch = min(s.chunk, seq)
    if seq % ch:
        raise ValueError(f"mamba2_fwd: sequence length {seq} is not a "
                         f"multiple of the chunk {ch}")
    nch, hdim, ng = seq // ch, s.head_dim, s.n_groups
    dt_ = x.dtype

    proj = x @ p.in_proj.to(dt_)
    x_in, z, b, c, dt = _split_proj(proj, cfg, nh)
    conv_in = torch.cat([x_in, b, c], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p.conv_w.to(dt_),
                                   p.conv_b.to(dt_)))
    del proj, conv_in, x_in, b, c
    x_in, b, c = torch.split(conv_out, (d_inner, ng * s.state,
                                        ng * s.state), dim=-1)
    xh = x_in.reshape(bsz, seq, nh, hdim)

    dt_s = _softplus(dt.to(torch.float32) + p.dt_bias)          # (B,S,H)
    a = -torch.exp(p.a_log)                                     # (H,)
    la = dt_s * a                                               # log decay
    xdt = xh * dt_s.to(dt_)[..., None]

    # --- chunked scan, heads before time: (B, N, H, ch, ...) ---
    cum = torch.cumsum(la.reshape(bsz, nch, ch, nh), dim=2)
    cum = cum.permute(0, 1, 3, 2)                               # (B,N,H,ch)
    xc = xdt.reshape(bsz, nch, ch, nh, hdim).permute(0, 1, 3, 2, 4)
    bg = b.reshape(bsz, nch, ch, ng, s.state).permute(0, 1, 3, 2, 4)
    cg = c.reshape(bsz, nch, ch, ng, s.state).permute(0, 1, 3, 2, 4)
    y = _ssd_intra(cum, cg, bg, xc)
    h_prev = _chunk_recurrence(_chunk_states(cum, bg, xc), cum[..., -1])
    y = y + _ssd_inter(cum, cg, h_prev)
    del h_prev
    y = y.permute(0, 1, 3, 2, 4).reshape(bsz, seq, nh, hdim)
    y = y + xh * p.d_skip.to(dt_)[:, None]
    return y.reshape(bsz, seq, d_inner), z


def init_mamba2_state(cfg: ArchConfig, batch: int,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> dict:
    """Zeroed decode state on `device` (None: the card; raises without
    one): `ssm` (B, H, N, P) and `conv`, the last K - 1 conv inputs (B,
    K - 1, D_i + 2 G N), float32 as the reference's default."""
    device = resolve_device(device)
    s = cfg.ssm
    d_inner, nh = dims(cfg)
    d_bc = 2 * s.n_groups * s.state
    return {"ssm": torch.zeros((batch, nh, s.state, s.head_dim),
                               dtype=dtype, device=device),
            "conv": torch.zeros((batch, s.conv_width - 1, d_inner + d_bc),
                                dtype=dtype, device=device)}


def mamba2_decode(p: Mamba2, x_t: torch.Tensor, state: dict,
                  cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """Exact single-token recurrence.  x_t: (B, D).  Returns (y (B, D),
    the new state): new tensors in the state's dtype, the caller's state
    untouched."""
    s = cfg.ssm
    bsz, _ = x_t.shape
    d_inner, nh = dims(cfg)
    ng = s.n_groups
    rep = nh // ng
    dt_ = x_t.dtype
    proj = x_t @ p.in_proj.to(dt_)
    x_in, z, b, c, dt = _split_proj(proj, cfg)
    conv_in = torch.cat([x_in, b, c], dim=-1)                   # (B, C)
    hist = torch.cat([state["conv"], conv_in[:, None, :].to(
        state["conv"].dtype)], dim=1)                           # (B, K, C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", hist.to(dt_),
                                   p.conv_w.to(dt_)) + p.conv_b.to(dt_))
    x_in, b, c = torch.split(conv_out, (d_inner, ng * s.state,
                                        ng * s.state), dim=-1)

    xh = x_in.reshape(bsz, nh, s.head_dim)
    bh = torch.repeat_interleave(b.reshape(bsz, ng, s.state), rep, dim=1)
    chd = torch.repeat_interleave(c.reshape(bsz, ng, s.state), rep, dim=1)
    dt_s = _softplus(dt.to(torch.float32) + p.dt_bias)          # (B,H)
    decay = torch.exp(dt_s * (-torch.exp(p.a_log)))             # (B,H)
    upd = torch.einsum("bhi,bhp->bhip", bh, xh * dt_s.to(dt_)[..., None])
    h_new = state["ssm"] * decay[..., None, None].to(state["ssm"].dtype) \
        + upd.to(state["ssm"].dtype)
    y = torch.einsum("bhi,bhip->bhp", chd, h_new.to(dt_))
    y = y + xh * p.d_skip.to(dt_)[None, :, None]
    y = _gated_rmsnorm(p.norm, y.reshape(bsz, d_inner), z)
    return y @ p.out_proj.to(dt_), {"ssm": h_new, "conv": hist[:, 1:, :]}
