"""CIM-in-the-loop LM training: the codesign loop picks a macro, then an
LM whose every FFN projection executes on that simulated macro
(binarization + ADC + static mismatch in the loop, straight-through
gradients) trains with plain SGD.

    python -m repro_torch.train.acim_lm --steps 200
    python -m repro_torch.train.acim_lm --d-model 768 --layers 12 \\
        --steps 300           # ~125M-class run (sized for real hardware)
    python -m repro_torch.train.acim_lm --device cpu --steps 3

Counterpart of the reference's `examples/train_acim_lm.py` (its
checkpointing aside).  It runs on CUDA unless given `--device`; on CUDA
each FFN projection is one launch of the `acim_matmul` kernel and the
codesign pick runs the explorer's `nsga2_evolve` kernel.  `--no-cim` trains
the same model on the exact digital path.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.codesign import Recommendation, recommend_macro
from repro_torch.data.synthetic import batch_for
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import causal_mask, softmax_cross_entropy
from repro_torch.models.lm import LM, init_lm, lm_logits
from repro_torch.quant.cim_linear import CIMConfig, cim_linear

# The codesign request of the reference's `examples/train_acim_lm.py`.
PICK = dict(array_size=16384, min_snr_db=3.0, pop_size=96, generations=25)
# The example's backbone dtype (the FFNs run in float32 on the macro).
BACKBONE_DTYPE = torch.bfloat16


def build_cfg(d_model: int = 128, layers: int = 4) -> ArchConfig:
    return ArchConfig(
        name="acim-lm", family="dense", n_layers=layers,
        d_model=d_model, n_heads=max(2, d_model // 64),
        n_kv_heads=max(2, d_model // 64), d_ff=d_model * 4,
        vocab=2048, norm="rmsnorm", act="silu", mlp_gated=False)


def pick_macro(cfg: ArchConfig, *, device=None, session=None
               ) -> Recommendation:
    """The codesign loop's macro for `cfg` (the example's request)."""
    return recommend_macro(cfg, session=session, device=device, **PICK)


def cim_logits(model: LM, inputs: torch.Tensor, cfg: ArchConfig,
               cim: CIMConfig | None, eps: dict | None = None
               ) -> torch.Tensor:
    """The CIM-native forward: a `BACKBONE_DTYPE` (bfloat16) backbone
    whose FFN `wi` / `wo` run in float32 on the macro (`cim_linear`),
    cast back to the backbone's dtype.  `eps` maps a weight shape to the
    mismatch draw that replaces the instance's default (`cim_linear`'s
    `eps`)."""
    eps = eps or {}
    x = model.emb[inputs].to(BACKBONE_DTYPE)
    s = x.shape[1]
    mask = causal_mask(s, x.device)
    pos = torch.arange(s, device=x.device)
    for blk in model.blocks:
        h = blk.ln1(x)
        x = x + attn.attention_fwd(blk.attn, h, cfg, mask=mask,
                                   positions=pos)
        h = blk.ln2(x).to(torch.float32)
        wi, wo = blk.ffn.wi, blk.ffn.wo
        ff = F.silu(cim_linear(h, wi, cim, eps=eps.get(tuple(wi.shape))))
        x = x + cim_linear(ff, wo, cim,
                           eps=eps.get(tuple(wo.shape))).to(x.dtype)
    x = model.final_norm(x)
    return lm_logits(model, x, cfg)


def loss_fn(model: LM, batch: dict, cfg: ArchConfig, cim: CIMConfig | None,
            eps: dict | None = None) -> torch.Tensor:
    logits = cim_logits(model, batch["inputs"], cfg, cim, eps)
    return softmax_cross_entropy(logits, batch["targets"])[0]


def sgd_step(model: LM, batch: dict, cfg: ArchConfig, cim: CIMConfig | None,
             lr: float, eps: dict | None = None) -> torch.Tensor:
    """One plain SGD step, p <- p - lr * g, updating the parameters in
    place.  Returns the step's loss (before the update)."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch, cfg, cim, eps)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(lr * p.grad)
    return loss.detach()


@dataclasses.dataclass
class TrainLog:
    losses: list[float]
    step_s: list[float]       # host seconds per step, each ending in a sync


def train(model: LM, cfg: ArchConfig, cim: CIMConfig | None, *, steps: int,
          seq: int, batch: int, lr: float, log=None) -> TrainLog:
    """`steps` SGD steps on the synthetic batches of steps 0..steps-1."""
    device = model.emb.device
    out = TrainLog([], [])
    t_start = time.perf_counter()
    for i in range(steps):
        t0 = time.perf_counter()
        b = batch_for(cfg, seq, batch, i, device=device)
        loss = float(sgd_step(model, b, cfg, cim, lr))   # waits for the step
        out.step_s.append(time.perf_counter() - t0)
        out.losses.append(loss)
        if log is not None and (i % 20 == 0 or i == steps - 1):
            log(f"step {i:4d} loss {loss:.4f} "
                f"({time.perf_counter() - t_start:.0f}s, "
                f"{1e3 * out.step_s[-1]:.1f} ms/step)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--no-cim", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = build_cfg(args.d_model, args.layers)
    if args.no_cim:
        cim = None
        print("digital (exact) FFN path")
    else:
        rec = pick_macro(cfg, device=device)
        cim = CIMConfig(rec.spec)
        print(f"codesign pick: {rec.spec} (SNR {rec.snr_db:.1f} dB, "
              f"util {rec.utilization:.2f}, {rec.eff_tops_per_w:.0f} TOPS/W, "
              f"{rec.macro_count_for_rate} macros @ 1 tok/us)")
    model = init_lm(cfg, seed=0, device=device)
    train(model, cfg, cim, steps=args.steps, seq=args.seq, batch=args.batch,
          lr=args.lr, log=lambda s: print(s, flush=True))
    print("done — CIM-in-the-loop training" if not args.no_cim
          else "done — digital baseline")


if __name__ == "__main__":
    main()
