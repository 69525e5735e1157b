"""Batched serving on the PyTorch port: continuous batching over the
decode step.  The port's counterpart of `examples/serve_acim.py`, with
the same output.

  PYTHONPATH=src python examples/torch/serve_acim.py [--arch qwen2.5-3b]
                                                     [--device cpu] [--smoke]

The reduced config of `--arch` (any family's: its decode step, through
`ServeEngine`), float32 weights from seed 0 on `--device` (default
`cuda`, which raises without a card).  `--smoke` serves three requests
of four new tokens each.
"""
import argparse
import time

from repro_torch.configs import registry as creg
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="three requests of four new tokens")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests, args.max_new = 3, 4

    cfg = creg.reduced(args.arch)
    params = build_model(cfg).init(seed=0, device=args.device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_seq=128,
                      device=args.device)
    for uid in range(args.requests):
        eng.submit(Request(uid=uid, prompt=[3 + uid, 7, 11],
                           max_new=args.max_new))
    t0 = time.time()
    done = eng.run(max_steps=512)
    dt = time.time() - t0
    toks = sum(len(c.tokens) for c in done)
    print(f"{len(done)} completions, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s, {args.slots} slots)")
    for c in sorted(done, key=lambda c: c.uid):
        print(f"  req {c.uid}: {c.tokens}")


if __name__ == "__main__":
    main()
