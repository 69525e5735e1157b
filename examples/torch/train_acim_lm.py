"""End-to-end driver on the PyTorch port: train an LM whose FFN
projections execute on the EasyACIM-generated macro (quantization + ADC
+ mismatch in the loop), with checkpoints and auto-resume.  The port's
counterpart of `examples/train_acim_lm.py`.

  PYTHONPATH=src python examples/torch/train_acim_lm.py --steps 200
  PYTHONPATH=src python examples/torch/train_acim_lm.py --d-model 768 \
      --layers 12 --steps 300     # ~125M-class run
  PYTHONPATH=src python examples/torch/train_acim_lm.py --device cpu --smoke

The macro is chosen by the codesign loop (`repro_torch.train.acim_lm
.pick_macro`); `--no-cim` trains the same model on the exact digital
path.  Every `--ckpt-every` steps the parameters go to `--ckpt-dir`
(`checkpoint.ckpt`); a run that finds a checkpoint there resumes after
its step, on the same batches, as if never stopped.  `--device`
defaults to `cuda` (raising without a card), where each FFN projection
is one `acim_matmul` launch.  `--smoke`: d 64, one layer, 4 steps (fewer
with `--steps`) of 2 x 32 tokens, a checkpoint every 2, the pick at pop
48 x 6 generations.
"""
import argparse
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.codesign import recommend_macro
from repro_torch.data.synthetic import batch_for
from repro_torch.models.lm import init_lm
from repro_torch.quant.cim_linear import CIMConfig
from repro_torch.train.acim_lm import PICK, build_cfg, sgd_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--no-cim", action="store_true")
    ap.add_argument("--ckpt-dir", default="runs/train_acim_lm")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny model, four steps, a small codesign budget")
    args = ap.parse_args(argv)
    pick = dict(PICK)
    if args.smoke:
        args.d_model, args.layers = 64, 1
        args.steps, args.seq, args.batch, args.ckpt_every = min(
            args.steps, 4), 32, 2, 2
        pick.update(pop_size=48, generations=6)

    cfg = build_cfg(args.d_model, args.layers)
    if args.no_cim:
        cim = None
        print("digital (exact) FFN path")
    else:
        rec = recommend_macro(cfg, device=args.device, **pick)
        cim = CIMConfig(rec.spec)
        print(f"codesign pick: {rec.spec} (SNR {rec.snr_db:.1f} dB, "
              f"util {rec.utilization:.2f}, {rec.eff_tops_per_w:.0f} TOPS/W, "
              f"{rec.macro_count_for_rate} macros @ 1 tok/us)")

    model = init_lm(cfg, seed=0, device=args.device)
    named = dict(model.named_parameters())
    start = ckpt.latest_step(args.ckpt_dir)
    if start is not None:
        saved = ckpt.restore(args.ckpt_dir, start, {"params": named})
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(saved["params"][n])
        print(f"resumed from step {start} in {args.ckpt_dir}")
    first = 0 if start is None else start + 1

    t0 = time.time()
    for i in range(first, args.steps):
        batch = batch_for(cfg, args.seq, args.batch, i, device=args.device)
        loss = float(sgd_step(model, batch, cfg, cim, args.lr))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {loss:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
        if (i + 1) % args.ckpt_every == 0 or i == args.steps - 1:
            ckpt.save(args.ckpt_dir, i, {"params": named})
    print("done — CIM-in-the-loop training converged" if not args.no_cim
          else "done — digital baseline")


if __name__ == "__main__":
    main()
