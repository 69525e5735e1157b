"""xLSTM mixers: mLSTM (matrix memory, exponential gating) and sLSTM
(scalar memory, recurrent gate mixing), per arXiv:2405.04517.

Counterpart of `repro.models.xlstm`.  The mLSTM's training forward is
the exact stabilized recurrence, a Python loop over time (`mlstm_fwd`);
`mlstm_fwd_chunked` is the chunkwise-parallel form that the prefill and
the train step run (within a chunk a masked linear-attention product,
across chunks a Python loop over the chunk states), equal to the
recurrence up to rounding.  The sLSTM is sequential (nonlinear recurrent
mixing) and always loops over time.  The reference computes all of it
with jnp under `lax.scan`, outside any Pallas kernel, so this is PyTorch
and cuBLAS: no kernel of ours runs here.

Blocks follow the paper's pre-LN residual structure with up/down
projection (proj_factor) and a causal conv on the mLSTM q/k path; the
products run in x's dtype and the recurrences in float32, with the
reference's casts between them (its `k / np.sqrt(dh)` divides a bf16
product by a float32 scalar, which promotes: k is float32).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import _draw_device, dense_init
from repro_torch.models.mamba2 import _causal_conv


def dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """(inner, heads, head dim) of the mLSTM: inner = proj_factor x D."""
    inner = int(cfg.xlstm.proj_factor * cfg.d_model)
    nh = cfg.n_heads
    if inner % nh:
        raise ValueError(f"{cfg.name!r}: mLSTM width {inner} is not a "
                         f"multiple of {nh} heads")
    return inner, nh, inner // nh


def _k_scale(dh: int) -> float:
    """sqrt(dh) in float32 (a NumPy scalar in the reference)."""
    return float(np.float32(np.sqrt(dh)))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
class MLSTM(nn.Module):
    """`up`, `gate` (D, inner); the causal conv `conv_w` (K, inner) (0.1 x
    standard normal) and `conv_b`; `wq`, `wk`, `wv` (inner, inner); the
    gate projection `w_if` (inner, 2 H) and `b_if` (input gates 0, forget
    gates 3); `down` (inner, D).  Drawn from `generator` in that order."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d = cfg.d_model
        inner, nh, _ = dims(cfg)
        self.up = nn.Parameter(dense_init(generator, (d, inner)))
        self.gate = nn.Parameter(dense_init(generator, (d, inner)))
        self.conv_w = nn.Parameter(0.1 * torch.randn(
            (cfg.xlstm.conv_width, inner), generator=generator,
            device=_draw_device(generator)))
        self.conv_b = nn.Parameter(torch.zeros(inner))
        self.wq = nn.Parameter(dense_init(generator, (inner, inner)))
        self.wk = nn.Parameter(dense_init(generator, (inner, inner)))
        self.wv = nn.Parameter(dense_init(generator, (inner, inner)))
        self.w_if = nn.Parameter(dense_init(generator, (inner, 2 * nh)))
        self.b_if = nn.Parameter(torch.cat([torch.zeros(nh),
                                            torch.full((nh,), 3.0)]))
        self.down = nn.Parameter(dense_init(generator, (inner, d)))


def init_mlstm(cfg: ArchConfig, generator: torch.Generator) -> MLSTM:
    return MLSTM(cfg, generator)


def mlstm_inputs(p: MLSTM, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The channel-wise part: (up, the output gate silu(x W_gate), the
    conv path silu(conv(up))), each (B, S, C) in x's dtype over the
    inner channels the weights hold (all of them, or a tensor-parallel
    position's own: the conv is depthwise)."""
    up = x @ p.up.to(x.dtype)
    gate = F.silu(x @ p.gate.to(x.dtype))
    conv = F.silu(_causal_conv(up, p.conv_w.to(x.dtype),
                               p.conv_b.to(x.dtype)))
    return up, gate, conv


def mlstm_heads(p: MLSTM, up: torch.Tensor, conv: torch.Tensor,
                cfg: ArchConfig) -> tuple[torch.Tensor, ...]:
    """q, v (B, S, H, dh) in up's dtype, k float32 (scaled by 1/sqrt(dh)),
    the log input and log forget gates (B, S, H) float32, from the whole
    `up` and `conv` (B, S, inner).  H is the weights' (`w_if`'s width /
    2: a tensor-parallel position's own heads, or all)."""
    b, s, _ = up.shape
    dh = dims(cfg)[2]
    nh = p.w_if.shape[1] // 2
    dt = up.dtype
    q = (conv @ p.wq.to(dt)).reshape(b, s, nh, dh)
    k = (conv @ p.wk.to(dt)).reshape(b, s, nh, dh).float() / _k_scale(dh)
    v = (up @ p.wv.to(dt)).reshape(b, s, nh, dh)
    if_ = conv @ p.w_if.to(dt) + p.b_if.to(dt)
    log_i = if_[..., :nh].float()
    log_f = F.logsigmoid(if_[..., nh:].float())
    return q, k, v, log_i, log_f


def _mlstm_qkvif(p: MLSTM, x: torch.Tensor, cfg: ArchConfig):
    """q, v (B, S, H, dh) in x's dtype, k float32 (scaled by 1/sqrt(dh)),
    the log input and log forget gates (B, S, H) float32, and the output
    gate silu(x W_gate) in x's dtype."""
    up, gate, conv = mlstm_inputs(p, x)
    return (*mlstm_heads(p, up, conv, cfg), gate)


def _mlstm_step(c, n, m, q, k, v, li, lf):
    """One step of the stabilized recurrence, float32: c (B, H, dh, dh),
    n (B, H, dh), m (B, H); q, k, v (B, H, dh); li, lf (B, H).  Returns
    (c, n, m, h (B, H, dh))."""
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)[..., None]
    ip = torch.exp(li - m_new)[..., None]
    c = c * fp[..., None] + ip[..., None] * (v[..., :, None] * k[..., None, :])
    n = n * fp + ip * k
    h_num = torch.einsum("bhvk,bhk->bhv", c, q)
    h_den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)),
                        min=1.0)
    return c, n, m_new, h_num / h_den[..., None]


def mlstm_fwd(p: MLSTM, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Exact stabilized recurrence over time (the reference's scan
    baseline), from m = -inf."""
    b, s, _ = x.shape
    inner, nh, dh = dims(cfg)
    q, k, v, log_i, log_f, gate = _mlstm_qkvif(p, x, cfg)
    q, v = q.float(), v.float()
    f32 = dict(dtype=torch.float32, device=x.device)
    c = torch.zeros((b, nh, dh, dh), **f32)
    n = torch.zeros((b, nh, dh), **f32)
    m = torch.full((b, nh), -torch.inf, **f32)
    hs = []
    for t in range(s):
        c, n, m, h = _mlstm_step(c, n, m, q[:, t], k[:, t], v[:, t],
                                 log_i[:, t], log_f[:, t])
        hs.append(h)
    h = torch.stack(hs, 1).reshape(b, s, inner).to(x.dtype)
    return (h * gate) @ p.down.to(x.dtype)


def mlstm_fwd_chunked(p: MLSTM, x: torch.Tensor,
                      cfg: ArchConfig) -> torch.Tensor:
    """Chunkwise-parallel mLSTM (linear-attention form within chunks).

    Per head, with cum_f[t] = sum_{u<=t} log f_u in the chunk and the
    input weight li[u],
        num[t] = sum_{u<=t} (q_t.k_u) e^{cum_f[t]-cum_f[u]+li[u]} v_u
                 + q_t . C_in e^{cum_f[t]}
        den[t] = the same with v -> 1 (through n)
        h[t]   = num[t] / max(|den[t]|, e^{m_abs[t]})
    where (C_in, n_in) are the unscaled states at the chunk's start and
    m_abs[t] the running max log weight: the stabilized recurrence's
    result.  A Python loop carries the states over the S / chunk chunk
    boundaries.  S must be a multiple of min(chunk, S), else
    `ValueError`."""
    q, k, v, log_i, log_f, gate = _mlstm_qkvif(p, x, cfg)
    h = mlstm_chunkwise(q, k, v, log_i, log_f, cfg).to(x.dtype)
    return (h * gate) @ p.down.to(x.dtype)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_i: torch.Tensor, log_f: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """The chunkwise cell of `mlstm_fwd_chunked` on the heads given (q,
    k, v (B, S, H, dh), the gates (B, S, H)): h (B, S, H dh) float32."""
    b, s, nh, dh = q.shape
    ch = min(cfg.xlstm.chunk, s)
    if s % ch:
        raise ValueError(f"sequence {s} is not a multiple of the mLSTM "
                         f"chunk {ch}")
    nch = s // ch
    qc = q.reshape(b, nch, ch, nh, dh).float()
    kc = k.reshape(b, nch, ch, nh, dh)
    vc = v.reshape(b, nch, ch, nh, dh).float()
    li = log_i.reshape(b, nch, ch, nh)
    lf = log_f.reshape(b, nch, ch, nh)

    cum_f = torch.cumsum(lf, dim=2)                       # (B,N,t,H)
    seg = cum_f[:, :, -1, :]                              # (B,N,H)
    wu = li - cum_f               # insertion weight relative to the start
    dmat = cum_f[:, :, :, None, :] + wu[:, :, None, :, :]  # (B,N,t,u,H)
    mask = torch.tril(torch.ones((ch, ch), dtype=torch.bool,
                                 device=q.device))[None, None, :, :, None]
    dexp = torch.where(mask, torch.exp(dmat), 0.0)

    scores = torch.einsum("bntha,bnuha->bntuh", qc, kc) * dexp
    num_intra = torch.einsum("bntuh,bnuhv->bnthv", scores, vc)
    den_intra = scores.sum(3)                             # (B,N,t,H)
    local_max = torch.where(mask, dmat, -torch.inf).amax(3)

    # the states each chunk adds: C' = e^seg C + sum_u e^{seg+wu[u]} k v^T
    w_in = torch.exp(wu + seg[:, :, None, :])             # (B,N,u,H)
    c_in = torch.einsum("bnuha,bnuh,bnuhv->bnhav", kc, w_in, vc)
    n_in = torch.einsum("bnuha,bnuh->bnha", kc, w_in)
    in_max = (wu + seg[:, :, None, :]).amax(2)            # (B,N,H)

    f32 = dict(dtype=torch.float32, device=q.device)
    c = torch.zeros((b, nh, dh, dh), **f32)
    n = torch.zeros((b, nh, dh), **f32)
    m = torch.full((b, nh), -torch.inf, **f32)
    prev = []
    for i in range(nch):
        prev.append((c, n, m))
        e = torch.exp(seg[:, i])
        c = c * e[..., None, None] + c_in[:, i]
        n = n * e[..., None] + n_in[:, i]
        m = torch.maximum(m + seg[:, i], in_max[:, i])
    c_prev, n_prev, m_prev = (torch.stack(t, 1) for t in zip(*prev))

    w_out = torch.exp(cum_f)                              # (B,N,t,H)
    num_inter = torch.einsum("bntha,bnhav,bnth->bnthv", qc, c_prev, w_out)
    den_inter = torch.einsum("bntha,bnha,bnth->bnth", qc, n_prev, w_out)
    num = num_intra + num_inter
    den = den_intra + den_inter
    m_abs = torch.maximum(local_max, m_prev[:, :, None, :] + cum_f)
    h = num / torch.maximum(torch.abs(den), torch.exp(m_abs))[..., None]
    return h.reshape(b, s, nh * dh)


def init_mlstm_state(cfg: ArchConfig, batch: int, device=None) -> dict:
    """The decode state, float32, on `device` (CUDA when None, raising
    without it): c (B, H, dh, dh), n (B, H, dh), m (B, H) at -1e30 and
    the conv history (B, K - 1, inner)."""
    dev = resolve_device(device)
    inner, nh, dh = dims(cfg)
    f32 = dict(dtype=torch.float32, device=dev)
    return {"c": torch.zeros((batch, nh, dh, dh), **f32),
            "n": torch.zeros((batch, nh, dh), **f32),
            "m": torch.full((batch, nh), -1e30, **f32),
            "conv": torch.zeros((batch, cfg.xlstm.conv_width - 1, inner),
                                **f32)}


def mlstm_decode(p: MLSTM, x_t: torch.Tensor, state: dict,
                 cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One token: x_t (B, D) -> (y (B, D), the new state)."""
    b = x_t.shape[0]
    inner, nh, dh = dims(cfg)
    dt = x_t.dtype
    up = x_t @ p.up.to(dt)
    gate = F.silu(x_t @ p.gate.to(dt))
    hist = torch.cat([state["conv"],
                      up[:, None, :].to(state["conv"].dtype)], 1)
    conv = F.silu(torch.einsum("bkc,kc->bc", hist.to(dt), p.conv_w.to(dt))
                  + p.conv_b.to(dt))
    q = (conv @ p.wq.to(dt)).reshape(b, nh, dh).float()
    k = (conv @ p.wk.to(dt)).reshape(b, nh, dh).float() / _k_scale(dh)
    v = (up @ p.wv.to(dt)).reshape(b, nh, dh).float()
    if_ = conv @ p.w_if.to(dt) + p.b_if.to(dt)
    c, n, m, h = _mlstm_step(state["c"], state["n"], state["m"], q, k, v,
                             if_[..., :nh].float(),
                             F.logsigmoid(if_[..., nh:].float()))
    y = (h.reshape(b, inner).to(dt) * gate) @ p.down.to(dt)
    return y, {"c": c, "n": n, "m": m, "conv": hist[:, 1:, :]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
class SLSTM(nn.Module):
    """`w_gates` (D, 4 D) (i, f, z, o), the per-head recurrent `r_gates`
    (H, dh, 4 dh) (0.2 x standard normal), `b_gates` (4 D: 0, 3, 0, 0 in
    blocks of D) and `down` (D, D).  Drawn from `generator` in that
    order."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        dh = d // nh
        self.w_gates = nn.Parameter(dense_init(generator, (d, 4 * d)))
        self.r_gates = nn.Parameter(0.2 * torch.randn(
            (nh, dh, 4 * dh), generator=generator,
            device=_draw_device(generator)))
        self.b_gates = nn.Parameter(torch.cat([
            torch.zeros(d), torch.full((d,), 3.0), torch.zeros(2 * d)]))
        self.down = nn.Parameter(dense_init(generator, (d, d)))


def init_slstm(cfg: ArchConfig, generator: torch.Generator) -> SLSTM:
    return SLSTM(cfg, generator)


def _slstm_scan(p: SLSTM, gx: torch.Tensor, cfg: ArchConfig, carry0):
    """gx: (B, S, 4 D) input-side gate preactivations; carry0 (c, n, m, h)
    each (B, H, dh) float32.  Returns ((c, n, m, h), hs (B, S, H, dh)).

    Each step adds h's recurrent term to gx's row read as (B, H, 4 dh)
    and splits it into i, f, z, o per head, as the reference does (so
    `b_gates`, laid out gate-major, reaches the heads' gates in blocks of
    dh).  `r_gates` is used in float32 (the reference's einsum promotes a
    bf16 one to h's float32)."""
    b, s, _ = gx.shape
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    r = p.r_gates.float()
    c, n, m, h = carry0
    seq = gx.float()
    hs = []
    for t in range(s):
        g = seq[:, t].reshape(b, nh, 4 * dh) + torch.einsum(
            "bhd,hdg->bhg", h, r)
        li, lf, z, o = torch.split(g, dh, dim=-1)
        lf = F.logsigmoid(lf)
        m_new = torch.maximum(lf + m, li)
        ip = torch.exp(li - m_new)
        fp = torch.exp(lf + m - m_new)
        c = fp * c + ip * torch.tanh(z)
        n = fp * n + ip
        h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    return (c, n, m, h), torch.stack(hs, 1)


def _slstm_carry(b: int, nh: int, dh: int, device) -> tuple:
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((b, nh, dh), **f32)
    return z, z, torch.full((b, nh, dh), -1e30, **f32), z


def slstm_fwd(p: SLSTM, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The sLSTM over a sequence from the zero state (m at -1e30)."""
    b, s, d = x.shape
    nh = cfg.n_heads
    gx = x @ p.w_gates.to(x.dtype) + p.b_gates.to(x.dtype)
    _, hs = _slstm_scan(p, gx, cfg, _slstm_carry(b, nh, d // nh, x.device))
    return hs.reshape(b, s, d).to(x.dtype) @ p.down.to(x.dtype)


def init_slstm_state(cfg: ArchConfig, batch: int, device=None) -> dict:
    """c, n, h zero and m at -1e30, each (B, H, dh) float32, on `device`
    (CUDA when None, raising without it)."""
    nh = cfg.n_heads
    c, n, m, h = _slstm_carry(batch, nh, cfg.d_model // nh,
                              resolve_device(device))
    return {"c": c, "n": n, "m": m, "h": h}


def slstm_decode(p: SLSTM, x_t: torch.Tensor, state: dict,
                 cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One token: x_t (B, D) -> (y (B, D), the new state)."""
    b, d = x_t.shape
    gx = x_t @ p.w_gates.to(x_t.dtype) + p.b_gates.to(x_t.dtype)
    (c, n, m, h), hs = _slstm_scan(
        p, gx[:, None, :], cfg,
        (state["c"], state["n"], state["m"], state["h"]))
    y = hs[:, 0].reshape(b, d).to(x_t.dtype) @ p.down.to(x_t.dtype)
    return y, {"c": c, "n": n, "m": m, "h": h}
