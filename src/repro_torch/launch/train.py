"""Training launcher with auto-restart supervision.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --steps 200 --seq 256 --batch 8 [--supervise]

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --reduced --mesh 2x2 --perf --steps 3

Counterpart of `repro.launch.train`.  --supervise wraps the run in the
in-process supervisor: preemption (SIGTERM) or injected node failures
checkpoint-and-restart until the step budget completes.  On a real
cluster the same entry point runs under the cluster's restart policy
(exit code 42 = retry).  --mesh AxB trains over a ("data", "model") mesh
of A x B positions (`launch.mesh.make_mesh`: the local cards
round-robin, so 2x2 on one card is four positions of it; with --device
cpu four CPU positions); 1x1 runs the one-device step.  --perf applies
`steps.PERF_TRAIN_OVERRIDES`, every key of it (qwen2.5-3b: ZeRO-3, one
microbatch; arctic: the bf16 cast), as the reference's dry-run variant
"perf" does; without it the strategy is "tp": tensor parallelism over
"model" (`parallel.tensor_parallel`: the dense and VLM families' heads,
FFN and vocabulary split, partial sums all-reduced; the MoE family's
experts, MLA or GQA heads, always-on FFNs and vocabulary likewise, its
load-balance loss over the whole microbatch; the other families' loss
once a model group on leaves gathered whole).
Checkpoints are written gathered, in the reference's layout: a run
resumes on any mesh.  --device defaults to the card (raising without
one); the CPU tests pass --device cpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.configs import registry as creg
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import PERF_TRAIN_OVERRIDES
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
                    help="AxB -> (data, model) mesh over the local devices")
    ap.add_argument("--perf", action="store_true",
                    help="apply the arch's PERF_TRAIN_OVERRIDES (strategy, "
                         "microbatches, bf16 cast)")
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = creg.reduced(args.arch) if args.reduced else creg.get(args.arch)
    device = resolve_device(args.device)
    d, m = (int(x) for x in args.mesh.split("x"))
    mesh = None if (d, m) == (1, 1) else make_mesh(
        (d, m), ("data", "model"), device=device)
    tcfg = TrainerConfig(seq=args.seq, global_batch=args.batch,
                         total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         microbatches=args.microbatches)
    if args.perf:
        # every key of the override is a `TrainerConfig` field; they are
        # keyed by the full config's name (a reduced config takes its
        # arch's)
        tcfg = dataclasses.replace(
            tcfg, **PERF_TRAIN_OVERRIDES.get(creg.get(args.arch).name, {}))

    guard = PreemptionGuard().install()

    def run_once() -> int:
        return train(cfg, tcfg, guard=guard, device=device,
                     mesh=mesh).exit_code

    try:
        if args.supervise:
            return run_supervised(run_once)
        return run_once()
    finally:
        guard.uninstall()


if __name__ == "__main__":
    sys.exit(main())
