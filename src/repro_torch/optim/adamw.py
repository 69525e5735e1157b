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


def _blocks(x: torch.Tensor, block: int, offset: int):
    """`x`, columns [offset, offset + n) of a leaf (0-d: one column), in
    the leaf's blocks of `block` columns that they touch: (..., k, block),
    zero-padded where a block runs past x's columns, and the index of the
    first of those blocks in the leaf."""
    xs = x if x.dim() else x[None]
    lead = offset % block
    k = _nblocks(lead + xs.shape[-1], block)
    xp = F.pad(xs, (lead, k * block - lead - xs.shape[-1]))
    return xp.reshape(xp.shape[:-1] + (k, block)), offset // block


def block_absmax(x: torch.Tensor, block: int, *, offset: int = 0,
                 width: int | None = None) -> torch.Tensor:
    """|x|'s max in each block of `block` columns of a leaf `width`
    columns wide (default x's own width: x is the whole leaf), x holding
    columns [offset, offset + n) of it: (..., n_blocks) float32, 0 in the
    blocks x does not reach and partial in a block x shares with another
    piece (the max of the pieces' rows is the whole leaf's)."""
    xb, b0 = _blocks(x, block, offset)
    amax = torch.amax(torch.abs(xb), dim=-1)
    nb = _nblocks(x.shape[-1] if width is None else width, block) \
        if x.dim() else 1
    k = amax.shape[-1]
    return F.pad(amax, (b0, nb - b0 - k)) if (b0, k) != (0, nb) else amax


def quantize_blockwise(x: torch.Tensor, block: int, *, offset: int = 0,
                       amax: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization in blocks along the last axis: (q like
    x, scales (..., n_blocks) float32).  `x` may be columns [offset,
    offset + n) of a leaf split on its last dimension: then `amax` is the
    whole leaf's `block_absmax` (its pieces' maxima all-reduced), blocks
    are counted along the whole leaf and the scales are the leaf's whole
    row (the reference's "scale drops the last dim's sharding")."""
    if amax is None:
        if offset:
            raise ValueError("a piece of a leaf quantizes with the whole "
                             "leaf's block maxima (amax)")
        amax = block_absmax(x, block)
    xb, b0 = _blocks(x, block, offset)
    # a tensor divisor: PyTorch's CUDA `div` multiplies by the reciprocal
    # of a host scalar, which can round apart from the CPU's (and the
    # reference's) division; a device tensor is divided exactly on both
    scale = amax / torch.full((), 127.0, device=amax.device) + 1e-12
    k = xb.shape[-2]
    q = torch.round(xb / scale[..., b0:b0 + k, None]).to(torch.int8)
    return _unblock(q, x, offset % block), scale


def _unblock(xb: torch.Tensor, like: torch.Tensor, lead: int) -> torch.Tensor:
    """The columns of `like` out of its blocks `xb` (`_blocks`)."""
    flat = xb.reshape(xb.shape[:-2] + (-1,))
    n = like.shape[-1] if like.dim() else 1
    return flat[..., lead:lead + n].reshape(like.shape)


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, block: int, *,
                         offset: int = 0) -> torch.Tensor:
    """float32 of `q` (columns [offset, offset + n) of a leaf) with the
    leaf's whole row of block scales `scale`."""
    qb, b0 = _blocks(q, block, offset)
    x = qb.to(torch.float32) * scale[..., b0:b0 + qb.shape[-2], None]
    return _unblock(x, q, offset % block)


def init(params: dict, cfg: AdamWConfig, *,
         widths: dict[str, int] | None = None) -> dict:
    """Zero moments like `params` (a dict of tensors) and count 0, on
    the parameters' device.  `widths` gives the whole leaf's last
    dimension where a parameter is a piece of it split on that dimension:
    its int8 moments' scales are the whole leaf's row of blocks."""
    dev = next(iter(params.values())).device
    widths = widths or {}
    if cfg.quantized_moments:
        def qzeros(n, p):
            width = widths.get(n, p.shape[-1] if p.dim() else 1)
            nb = _nblocks(width, cfg.quant_block)
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.zeros(tuple(p.shape[:-1]) + (nb,),
                                     dtype=torch.float32, device=p.device)}

        return {"m": {n: qzeros(n, p) for n, p in params.items()},
                "v": {n: qzeros(n, p) for n, p in params.items()},
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


class Update:
    """One AdamW step over `params` taken leaf by leaf: `leaf` updates a
    parameter in place and returns its new float32 moments, `store`
    writes a moment into `opt_state`, `finish` sets the count and gives
    the metrics.  `update` runs every leaf in turn; a mesh's step takes
    each leaf on every position before it stores the int8 moments of a
    leaf split on its last dimension, whose block maxima its positions
    all-reduce first.  `norm` is the global grad norm the clip reads."""

    def __init__(self, opt_state: dict, params: dict, cfg: AdamWConfig,
                 norm: torch.Tensor):
        self.opt_state, self.params, self.cfg, self.norm = (
            opt_state, params, cfg, norm)
        self.count = opt_state["count"] + 1
        self.scale = torch.clamp(cfg.clip_norm / (norm + 1e-9), max=1.0)
        self.lr = schedule(cfg, self.count)
        self.bc1 = 1.0 - cfg.b1 ** self.count.to(torch.float32)
        self.bc2 = 1.0 - cfg.b2 ** self.count.to(torch.float32)
        self.decay = _decay_mask(params)

    @torch.no_grad()
    def leaf(self, name: str, grad: torch.Tensor, *, offset: int = 0
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Update parameter `name` with `grad` in place; (m, v) new, in
        float32.  `offset` is the parameter's first column in the whole
        leaf, where it is a piece split on its last dimension."""
        cfg, p = self.cfg, self.params[name]
        m, v = self.opt_state["m"][name], self.opt_state["v"][name]
        g = grad.to(torch.float32) * self.scale
        if cfg.quantized_moments:
            mf = dequantize_blockwise(m["q"], m["s"], cfg.quant_block,
                                      offset=offset)
            vf = dequantize_blockwise(v["q"], v["s"], cfg.quant_block,
                                      offset=offset)
        else:
            mf, vf = m.to(torch.float32), v.to(torch.float32)
        m2 = cfg.b1 * mf + (1 - cfg.b1) * g
        v2 = cfg.b2 * vf + (1 - cfg.b2) * g * g
        del g, mf, vf
        step = (m2 / self.bc1) / (torch.sqrt(v2 / self.bc2) + cfg.eps)
        pf = p.to(torch.float32)
        if self.decay[name]:
            step = step + cfg.weight_decay * pf
        p.copy_(pf - self.lr * step)
        return m2, v2

    @torch.no_grad()
    def store(self, name: str, which: str, new: torch.Tensor, *,
              offset: int = 0, amax: torch.Tensor | None = None) -> None:
        """Write moment `which` ("m" or "v") of `name`: int8 blocks with
        their scales (from `amax`, the whole leaf's block maxima, where
        the parameter is a piece at column `offset`), else a copy."""
        mom = self.opt_state[which][name]
        if self.cfg.quantized_moments:
            q, s = quantize_blockwise(new, self.cfg.quant_block,
                                      offset=offset, amax=amax)
            mom["q"].copy_(q)
            mom["s"].copy_(s)
        else:
            mom.copy_(new)

    def finish(self) -> dict:
        """Set the state's count; AdamW's metrics as 0-dim tensors."""
        self.opt_state["count"] = self.count
        return {"grad_norm": self.norm, "lr": self.lr,
                "clip_scale": self.scale}


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
    up = Update(opt_state, params, cfg,
                global_norm(grads) if norm is None else norm)
    for name in params:
        m2, v2 = up.leaf(name, grads[name])
        up.store(name, "m", m2)
        up.store(name, "v", v2)
        del m2, v2
    return params, opt_state, up.finish()
