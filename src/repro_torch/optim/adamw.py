"""AdamW with the reference's formulas, in its order.

Counterpart of `repro.optim.adamw`: configurable moment dtype (float32
default, bf16 halves the optimizer's memory), int8 blockwise moments,
global-norm gradient clipping, decoupled weight decay with the
reference's no-decay filter, bias correction and a cosine schedule with
linear warmup.

Trees are flat dicts keyed by the `LM`'s state-dict names
(`blocks.<i>.attn.wq`, ...): the port holds a layer per tensor where the
reference stacks the layers on a leading axis.  Every rule that reads a
rank reads the stacked one (`models.lm.stacked_ndim`).  State is
`{"m": {name: moment}, "v": {...}, "count": int32 0-dim tensor}`; a
quantized moment is `{"q": int8, "s": float32 scales}`.

`update` runs leaf by leaf and writes parameters and moments in place
(the reference's jitted step donates its state): what it holds beside
the state is one leaf's temporaries, the counterpart of the reference's
`lax.map` over the stacked axis (so its `scan_update_threshold`, the
leaf size from which it maps, has no counterpart).  Each formula is one
PyTorch operation per reference operation, in the reference's order (no
fused `alpha` or `addcmul`, which would round once where the reference
rounds twice).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.lm import stacked_ndim


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32
    quantized_moments: bool = False   # int8 blockwise m/v (4x memory saving)
    quant_block: int = 256
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr (float32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _decay_mask(params: dict) -> dict[str, bool]:
    """True where weight decay applies: leaves of stacked rank >= 2.
    Every tensor of a layer decays, its norms and biases included (the
    reference's stacked leaves are >= 2-D); `final_norm.scale` does not."""
    return {n: stacked_ndim(n, p) >= 2 for n, p in params.items()}


def _nblocks(n: int, block: int) -> int:
    return max(1, -(-n // block))


def quantize_blockwise(x: torch.Tensor,
                       block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization in blocks along the last axis: (q like
    x, scales (..., n_blocks) float32)."""
    shape = x.shape
    last = shape[-1] if shape else 1
    nb = _nblocks(last, block)
    pad = nb * block - last
    xp = F.pad(x if shape else x[None], (0, pad))
    xb = xp.reshape(xp.shape[:-1] + (nb, block))
    # a tensor divisor: PyTorch's CUDA `div` multiplies by the reciprocal
    # of a host scalar, which can round apart from the CPU's (and the
    # reference's) division; a device tensor is divided exactly on both
    scale = torch.amax(torch.abs(xb), dim=-1) / torch.full(
        (), 127.0, device=xb.device) + 1e-12
    q = torch.round(xb / scale[..., None]).to(torch.int8)
    q = q.reshape(xp.shape[:-1] + (nb * block,))
    return (q[..., :last].reshape(shape) if pad else q.reshape(shape)), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         block: int) -> torch.Tensor:
    shape = q.shape
    last = shape[-1] if shape else 1
    nb = scale.shape[-1]
    pad = nb * block - last
    qp = F.pad(q if shape else q[None], (0, pad))
    xb = qp.reshape(qp.shape[:-1] + (nb, block)).to(torch.float32)
    x = xb * scale[..., None]
    return x.reshape(qp.shape[:-1] + (nb * block,))[..., :last].reshape(shape)


def init(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments like `params` (a dict of tensors) and count 0, on
    the parameters' device."""
    dev = next(iter(params.values())).device
    if cfg.quantized_moments:
        def qzeros(p):
            nb = _nblocks(p.shape[-1] if p.dim() else 1, cfg.quant_block)
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.zeros(tuple(p.shape[:-1]) + (nb,),
                                     dtype=torch.float32, device=p.device)}

        return {"m": {n: qzeros(p) for n, p in params.items()},
                "v": {n: qzeros(p) for n, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32, device=dev)}
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,  # noqa: E731
                                  device=p.device)
    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32 (the
    reference sums its stacked leaves, this one layer leaves: the sums
    agree to float32 rounding)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


@torch.no_grad()
def update(grads: dict, opt_state: dict, params: dict,
           cfg: AdamWConfig, *,
           norm: torch.Tensor | None = None) -> tuple[dict, dict, dict]:
    """One AdamW step.  Writes `params`' tensors and `opt_state`'s moments
    in place, replaces its count, and returns (params, opt_state,
    metrics): `grad_norm`, `lr` and `clip_scale` as 0-dim tensors.
    `norm` is the global grad norm where `grads` are one position's
    shards of a mesh (the clip reads the whole tree's norm); by default
    `global_norm(grads)`."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, count)
    bc1 = 1.0 - cfg.b1 ** count.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** count.to(torch.float32)
    decay = _decay_mask(params)
    for name, p in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].to(torch.float32) * scale
        if cfg.quantized_moments:
            mf = dequantize_blockwise(m["q"], m["s"], cfg.quant_block)
            vf = dequantize_blockwise(v["q"], v["s"], cfg.quant_block)
        else:
            mf, vf = m.to(torch.float32), v.to(torch.float32)
        m2 = cfg.b1 * mf + (1 - cfg.b1) * g
        v2 = cfg.b2 * vf + (1 - cfg.b2) * g * g
        del g, mf, vf
        step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        if decay[name]:
            step = step + cfg.weight_decay * pf
        p.copy_(pf - lr * step)
        del step, pf
        if cfg.quantized_moments:
            for mom, new in ((m, m2), (v, v2)):
                q, s = quantize_blockwise(new, cfg.quant_block)
                mom["q"].copy_(q)
                mom["s"].copy_(s)
        else:
            m.copy_(m2)
            v.copy_(v2)
    opt_state["count"] = count
    metrics = {"grad_norm": gnorm, "lr": lr, "clip_scale": scale}
    return params, opt_state, metrics
