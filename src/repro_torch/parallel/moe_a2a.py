"""Expert-parallel MoE with an explicit all-to-all dispatch.

Counterpart of `repro.parallel.moe_a2a`.  The reference packs the tokens
into per-destination capacity buffers, exchanges them with one
`jax.lax.all_to_all` over the expert mesh axis, runs each shard's local
experts and exchanges the results back.  Here a mesh is the port's: a
tuple of `torch.device` positions in one process, repeats allowed
(`repro_torch.parallel.distributed_explorer.as_mesh`), used as the
expert axis.  Position j holds experts [j E/n, (j + 1) E/n); the
all-to-all is the copy of the send buffer's row j to position j and of
its expert outputs back.  Each position computes under its own device
(`torch.cuda.device`, the rule `kernels._build.launch` follows), so the
positions may be cards of one host; there is no `torch.distributed`.

Semantics match `models.mlp.moe_fwd` up to the capacity-drop order (one
queue per expert over all tokens, not per group); with a capacity that
drops nothing both equal the drop-free `moe_fwd_dense_eval`.  The router
aux losses are omitted, as in the reference (its GSPMD path computes
them; this is the serving path).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import act_fn
from repro_torch.models.mlp import add_always_on, router_probs
from repro_torch.parallel.distributed_explorer import as_mesh


def _on(dev: torch.device):
    """`dev` current while a position computes (a no-op off CUDA)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def moe_fwd_a2a(p, x: torch.Tensor, cfg: ArchConfig, mesh, *,
                capacity: int | None = None) -> torch.Tensor:
    """x: (B, S, D) -> y like x, on x's device.  `p` is an `MoE` (the
    experts are sliced per position and copied there when they live
    elsewhere).  `capacity` slots per expert over all B S tokens; by
    default the reference's ceil(B S k cf / E) * 4."""
    m = cfg.moe
    mesh = as_mesh(mesh)
    n = len(mesh)
    if m.n_experts % n:
        raise ValueError(f"{m.n_experts} experts do not split over {n} "
                         f"positions")
    e_local = m.n_experts // n
    b, s, d = x.shape
    if capacity is None:
        capacity = math.ceil(b * s * m.top_k * m.capacity_factor
                             / m.n_experts) * 4
    t = b * s
    xt = x.reshape(t, d)
    _, _, top_p, top_i = router_probs(p, xt, m)
    # slot of each (token, k) claim inside its expert queue, token-major
    flat = F.one_hot(top_i, m.n_experts).to(torch.float32).reshape(
        t * m.top_k, m.n_experts)
    pos = torch.cumsum(flat, dim=0) - flat
    expert = top_i.reshape(-1)
    slot = torch.gather(pos, 1, expert[:, None])[:, 0].to(torch.int64)
    keep = slot < capacity
    dst, e_in = expert // e_local, expert % e_local
    at = torch.where(keep, slot, capacity - 1)
    tok = torch.arange(t, device=x.device).repeat_interleave(m.top_k)

    # pack the send buffer (n, e_local, capacity, D); a dropped claim adds
    # its zero row to its expert's last slot, as the reference does
    send = x.new_zeros((n, e_local, capacity, d)).index_put_(
        (dst, e_in, at), torch.where(keep[:, None], xt[tok], 0.0),
        accumulate=True)
    act = act_fn(cfg.act)
    back = []
    for j, dev in enumerate(mesh):
        with _on(dev):
            recv = send[j].to(dev)                     # the all-to-all
            # one product per expert: a batched product's kernel may
            # change with its batch count, and the result must not
            # depend on how many experts share a position
            ye = []
            for e in range(j * e_local, (j + 1) * e_local):
                wi, wg, wo = (w[e].to(device=dev, dtype=x.dtype)
                              for w in (p.wi, p.wg, p.wo))
                xe = recv[e - j * e_local]
                ye.append((act(xe @ wg) * (xe @ wi)) @ wo)
        back.append(torch.stack(ye).to(x.device))     # ... and back
    back = torch.stack(back)
    gathered = torch.where(keep[:, None], back[dst, e_in, at], 0.0)
    w = (top_p.reshape(-1) * keep)[:, None].to(x.dtype)
    # each token's k claims are consecutive rows: summed in a fixed order
    # (a scatter-add with atomics would not give the same bits twice)
    yt = (gathered * w).reshape(t, m.top_k, d).sum(1)
    return add_always_on(p, x, yt.reshape(b, s, d), cfg)
