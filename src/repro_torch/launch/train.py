"""Training launcher with auto-restart supervision.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --steps 200 --seq 256 --batch 8 [--supervise]

Counterpart of `repro.launch.train` on one device.  --supervise wraps
the run in the in-process supervisor: preemption (SIGTERM) or injected
node failures checkpoint-and-restart until the step budget completes.
On a real cluster the same entry point runs under the cluster's restart
policy (exit code 42 = retry).  The port has no mesh, so --mesh takes
only 1x1.  --device defaults to the card (raising without one); the CPU
tests pass --device cpu.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import registry as creg
from repro_torch.device import resolve_device
from repro_torch.runtime.fault_tolerance import PreemptionGuard, run_supervised
from repro_torch.train.trainer import TrainerConfig, train


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (smoke) config of the family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="runs/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", default="1x1",
                    help="AxB (data, model) mesh; the port runs 1x1 only")
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise SystemExit(f"--mesh {args.mesh}: the port trains on one "
                         f"device (1x1); sharded meshes are not ported")
    cfg = creg.reduced(args.arch) if args.reduced else creg.get(args.arch)
    device = resolve_device(args.device)
    tcfg = TrainerConfig(seq=args.seq, global_batch=args.batch,
                         total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         microbatches=args.microbatches)

    guard = PreemptionGuard().install()

    def run_once() -> int:
        return train(cfg, tcfg, guard=guard, device=device).exit_code

    try:
        if args.supervise:
            return run_supervised(run_once)
        return run_once()
    finally:
        guard.uninstall()


if __name__ == "__main__":
    sys.exit(main())
