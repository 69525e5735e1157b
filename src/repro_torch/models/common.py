"""Shared model building blocks: norms, RoPE, masks, losses, init.

Counterpart of the parts of `repro.models.common` the dense decoder
uses.  Parameters live in `nn.Module`s that keep the reference's
parameter names (`scale`, `bias`), so the reference's pytrees map onto
them (`repro_torch.convert.lm_params_from_numpy`).  Initializers draw
from an explicit `torch.Generator`; they keep the reference's
distributions, not its bits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def _draw_device(generator: torch.Generator):
    """Where a draw from `generator` is made: the generator's own device,
    or for a CPU generator the default device (so that `LM` built under
    `torch.device("meta")` allocates nothing)."""
    return None if generator.device.type == "cpu" else generator.device


def dense_init(generator: torch.Generator, shape: tuple[int, ...],
               in_axis: int = 0) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(fan_in), float32, on
    the generator's device."""
    fan_in = shape[in_axis]
    t = torch.empty(shape, dtype=torch.float32,
                    device=_draw_device(generator))
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(float(1.0 / np.sqrt(fan_in)))


def embed_init(generator: torch.Generator,
               shape: tuple[int, ...]) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=_draw_device(generator)) * 0.02


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale).to(x.dtype)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class Norm(nn.Module):
    """RMSNorm (`scale`) or LayerNorm (`scale`, `bias`) parameters."""

    def __init__(self, d: int, kind: str):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d))
        if kind != "rmsnorm":
            self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self, x, self.kind)


def init_norm(d: int, kind: str) -> Norm:
    return Norm(d, kind)


def apply_norm(p: Norm, x: torch.Tensor, kind: str) -> torch.Tensor:
    return rmsnorm(p.scale, x) if kind == "rmsnorm" else layernorm(
        p.scale, p.bias, x)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, Dh) with positions (..., S) or (S,)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention masks
# ---------------------------------------------------------------------------
def causal_mask(s: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          z_loss: float = 1e-4) -> tuple[torch.Tensor, dict]:
    """Token-mean CE with a z-loss (logit-norm regularizer used by
    production LM stacks for bf16 stability).  logits (..., V), labels (...)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    zl = z_loss * torch.square(lse)
    loss = torch.mean(nll + zl)
    metrics = {"nll": torch.mean(nll), "z_loss": torch.mean(zl),
               "ppl_proxy": torch.exp(torch.clamp(torch.mean(nll), max=20.0))}
    return loss, metrics


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def act_fn(name: str):
    """The reference's activations (its "gelu" is the tanh form, as
    `jax.nn.gelu` defaults to)."""
    gelu_tanh = lambda x: F.gelu(x, approximate="tanh")  # noqa: E731
    return {"silu": F.silu, "gelu": gelu_tanh, "gelu_tanh": gelu_tanh,
            "relu": F.relu}[name]
