"""FFN mixers: the dense (gated / plain) MLP and the Mixture-of-Experts.

Counterpart of `repro.models.mlp`.  The MoE is the reference's
group-wise capacity dispatch (Switch / GShard style): tokens are cut
into groups of `group_size`, each (token, k) claim takes the next slot
of its expert's queue in its group, claims past the capacity C are
dropped, the experts run as one (E, ...) batched product over their (G,
C) slots, and a combine product scatters the gated results back.  The
router and its aux losses are float32; everything else runs in x's
dtype.  The reference computes all of it with einsums outside any
Pallas kernel, so this is PyTorch and cuBLAS.  The all-to-all variant
over a mesh of devices is `repro_torch.parallel.moe_a2a`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.common import act_fn, dense_init


class MLP(nn.Module):
    """`wi` (D, F), `wo` (F, D); `wg` (D, F) when gated; `bi`, `bo`
    with `mlp_bias`."""

    def __init__(self, d: int, ff: int, cfg: ArchConfig,
                 generator: torch.Generator):
        super().__init__()
        self.wi = nn.Parameter(dense_init(generator, (d, ff)))
        self.wo = nn.Parameter(dense_init(generator, (ff, d)))
        if cfg.mlp_gated:
            self.wg = nn.Parameter(dense_init(generator, (d, ff)))
        if cfg.mlp_bias:
            self.bi = nn.Parameter(torch.zeros(ff))
            self.bo = nn.Parameter(torch.zeros(d))


def init_mlp(d: int, ff: int, cfg: ArchConfig,
             generator: torch.Generator) -> MLP:
    return MLP(d, ff, cfg, generator)


def mlp_fwd(p: MLP, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    act = act_fn(cfg.act)
    h = x @ p.wi.to(x.dtype)
    if cfg.mlp_bias:
        h = h + p.bi.to(x.dtype)
    if cfg.mlp_gated:
        h = act(x @ p.wg.to(x.dtype)) * h
    else:
        h = act(h)
    y = h @ p.wo.to(x.dtype)
    if cfg.mlp_bias:
        y = y + p.bo.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_capacity(m: MoEConfig) -> int:
    """Slots per (group, expert): the group's claims times the capacity
    factor over the experts, rounded up to a multiple of 4 (at least 4)."""
    c = math.ceil(m.group_size * m.top_k * m.capacity_factor / m.n_experts)
    return max(4, math.ceil(c / 4) * 4)


class GatedFFN(nn.Module):
    """An always-on gated FFN beside the experts: `wi`, `wg` (D, F) and
    `wo` (F, D) (the reference's `shared` and `dense` dicts)."""

    def __init__(self, d: int, ff: int, generator: torch.Generator):
        super().__init__()
        self.wi = nn.Parameter(dense_init(generator, (d, ff)))
        self.wg = nn.Parameter(dense_init(generator, (d, ff)))
        self.wo = nn.Parameter(dense_init(generator, (ff, d)))


class MoE(nn.Module):
    """`router` (D, E); the experts' `wi`, `wg` (E, D, F) and `wo` (E, F,
    D), fan-in on axis 1; `shared` (n_shared experts fused to width
    n_shared * F) and `dense` (Arctic's residual FFN) where the config
    has them."""

    def __init__(self, d: int, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        m = cfg.moe
        e, f = m.n_experts, m.d_ff_expert
        self.router = nn.Parameter(dense_init(generator, (d, e)))
        self.wi = nn.Parameter(dense_init(generator, (e, d, f), in_axis=1))
        self.wg = nn.Parameter(dense_init(generator, (e, d, f), in_axis=1))
        self.wo = nn.Parameter(dense_init(generator, (e, f, d), in_axis=1))
        if m.n_shared:
            self.shared = GatedFFN(d, f * m.n_shared, generator)
        if m.dense_ff:
            self.dense = GatedFFN(d, m.dense_ff, generator)


def init_moe(d: int, cfg: ArchConfig, generator: torch.Generator) -> MoE:
    return MoE(d, cfg, generator)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, largest first, the lower index
    first among equal values (as `jax.lax.top_k`; `torch.topk` orders
    ties as it likes, and a zero router makes every probability equal)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_probs(p, x: torch.Tensor, m: MoEConfig):
    """Softmax router with top-k selection in float32.  x: (..., D) ->
    (logits, probs (..., E), top_p (..., k) renormalized, top_i)."""
    logits = x.to(torch.float32) @ p.router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, m.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    return logits, probs, top_p, top_i


def _aux_losses(logits: torch.Tensor, probs: torch.Tensor,
                top_i: torch.Tensor, m: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance loss plus the router z-loss, float32."""
    e = m.n_experts
    onehot = F.one_hot(top_i, e).to(torch.float32)             # (..., k, E)
    frac_tokens = onehot.sum(-2).mean(tuple(range(onehot.dim() - 2)))
    frac_probs = probs.mean(tuple(range(probs.dim() - 1)))
    lb = e * torch.sum(frac_tokens * frac_probs) / m.top_k
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return m.router_aux_weight * lb + m.router_z_weight * z


def add_always_on(p, x: torch.Tensor, y: torch.Tensor,
                   cfg: ArchConfig) -> torch.Tensor:
    """y plus the shared experts' output, then plus the dense residual
    FFN's, where the config has them (the reference's order)."""
    m, act = cfg.moe, act_fn(cfg.act)
    for part in (p.shared if m.n_shared else None,
                 p.dense if m.dense_ff else None):
        if part is not None:
            y = y + (act(x @ part.wg.to(x.dtype))
                     * (x @ part.wi.to(x.dtype))) @ part.wo.to(x.dtype)
    return y


def moe_route(p, xg: torch.Tensor, m: MoEConfig):
    """The group-wise dispatch decision for xg (G, gs, D): `(logits,
    probs, top_p, top_i, slot, keep)`.  `slot` (G, gs, k) is each (token,
    k) claim's position in its expert's queue within the group, claims
    taken token-major; `keep` (float32) is 1 where the slot is under the
    capacity.  Slots are counted in float32, as the reference does: exact
    for the group sizes a config has."""
    g, gs, _ = xg.shape
    logits, probs, top_p, top_i = router_probs(p, xg, m)
    claims = F.one_hot(top_i, m.n_experts).to(torch.float32)
    flat = claims.reshape(g, gs * m.top_k, m.n_experts)
    pos_in_e = torch.cumsum(flat, dim=1) - flat
    slot = torch.gather(pos_in_e, 2, top_i.reshape(g, gs * m.top_k, 1))
    slot = slot.reshape(g, gs, m.top_k)
    keep = (slot < moe_capacity(m)).to(torch.float32)
    return logits, probs, top_p, top_i, slot, keep


def moe_dispatch(xg: torch.Tensor, top_i: torch.Tensor, slot: torch.Tensor,
                 keep: torch.Tensor, gate: torch.Tensor, n_experts: int,
                 capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(xe (G, E, C, D), the combine tensor (G, gs, E, C)) in xg's dtype.

    The reference builds its dispatch and combine tensors as one-hot
    einsums, the combine from three operands; each of their (g, s, e,
    c) entries has at most one non-zero term (a token claims an expert
    once), so they are written here by index, equal to the einsums'
    values without their (G, gs, k, E, C) intermediates.  The dispatch
    itself is the reference's einsum (a batched product)."""
    g, gs, _ = xg.shape
    dev = xg.device
    # (g, s, expert, slot) of each claim; a dropped claim writes its 0 to
    # slot 0 of its expert, an entry no other claim of the token has
    idx = (torch.arange(g, device=dev)[:, None, None].expand_as(top_i),
           torch.arange(gs, device=dev)[None, :, None].expand_as(top_i),
           top_i, torch.where(keep > 0, slot, 0).long())
    shape = (g, gs, n_experts, capacity)
    disp = xg.new_zeros(shape).index_put_(idx, keep.to(xg.dtype))
    comb = xg.new_zeros(shape).index_put_(idx, gate.to(xg.dtype))
    return torch.einsum("gsec,gsd->gecd", disp, xg), comb


def moe_experts(p, xe: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Every expert's gated FFN on its (G, C) slots: (G, E, C, D)."""
    hi = torch.einsum("gecd,edf->gecf", xe, p.wi.to(xe.dtype))
    hg = torch.einsum("gecd,edf->gecf", xe, p.wg.to(xe.dtype))
    return torch.einsum("gecf,efd->gecd", act_fn(cfg.act)(hg) * hi,
                        p.wo.to(xe.dtype))


def moe_combine(comb: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """The gated sum of each token's expert outputs: (G, gs, D)."""
    return torch.einsum("gsec,gecd->gsd", comb, ye)


def moe_fwd(p: MoE, x: torch.Tensor,
            cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-wise capacity MoE.  x: (B, S, D) -> (y, aux_loss float32).

    Groups of min(group_size, B S) tokens dispatch independently into (E,
    C) slots: `moe_route`, `moe_dispatch`, `moe_experts`, `moe_combine`
    (module functions, so that a profiler can wrap each), then the
    always-on FFNs."""
    m = cfg.moe
    b, s, d = x.shape
    gs = min(m.group_size, b * s)
    if (b * s) % gs:
        raise ValueError(f"{b} x {s} tokens do not split into groups of {gs}")
    xg = x.reshape((b * s) // gs, gs, d)
    logits, probs, top_p, top_i, slot, keep = moe_route(p, xg, m)
    aux = _aux_losses(logits, probs, top_i, m)
    xe, comb = moe_dispatch(xg, top_i, slot, keep, top_p * keep,
                            m.n_experts, moe_capacity(m))
    y = moe_combine(comb, moe_experts(p, xe, cfg)).reshape(b, s, d)
    return add_always_on(p, x, y, cfg), aux


def moe_fwd_dense_eval(p: MoE, x: torch.Tensor,
                       cfg: ArchConfig) -> torch.Tensor:
    """The drop-free MoE: every expert on every token, gated sum.  O(E)
    compute; the oracle that bounds the dropping error."""
    m = cfg.moe
    _, probs, top_p, top_i = router_probs(p, x, m)
    gates = torch.sum(F.one_hot(top_i, m.n_experts).to(probs.dtype)
                      * top_p[..., None], dim=-2)
    hi = torch.einsum("bsd,edf->bsef", x, p.wi.to(x.dtype))
    hg = torch.einsum("bsd,edf->bsef", x, p.wg.to(x.dtype))
    ye = torch.einsum("bsef,efd->bsed", act_fn(cfg.act)(hg) * hi,
                      p.wo.to(x.dtype))
    y = torch.einsum("bse,bsed->bsd", gates.to(x.dtype), ye)
    return add_always_on(p, x, y, cfg)
