"""Codesign showcase on the PyTorch port: recommend an ACIM macro for
every assigned architecture (the paper's Fig. 1 'versatile scenarios',
made quantitative).  The port's counterpart of
`examples/codesign_sweep.py`, with the same output.

  PYTHONPATH=src python examples/torch/codesign_sweep.py [--device cpu]
                                                         [--smoke]

`--device` is where the explorer runs (default `cuda`; one session is
shared across the architectures); `--smoke` takes a 4 kb array at pop
48 x 6 generations and the first two architectures.
"""
import argparse

from repro_torch.api import DesignSession
from repro_torch.configs import registry as creg
from repro_torch.core.codesign import recommend_macro


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a small budget over two architectures")
    args = ap.parse_args(argv)
    if args.smoke:
        names, budget = creg.ARCH_IDS[:2], dict(array_size=4096, pop_size=48,
                                                generations=6)
    else:
        names, budget = creg.ARCH_IDS, dict(array_size=65536, pop_size=96,
                                            generations=25)
    session = DesignSession(device=args.device)
    print(f"{'arch':24s} {'macro (H,W,L,B)':>20s} {'SNR':>6s} {'util':>5s} "
          f"{'TOPS/W':>7s} {'#macros@1tok/us':>15s}")
    for name in names:
        cfg = creg.get(name)
        rec = recommend_macro(cfg, min_snr_db=3.0, seed=7, session=session,
                              **budget)
        s = rec.spec
        print(f"{cfg.name:24s} {str((s.h, s.w, s.l, s.b_adc)):>20s} "
              f"{rec.snr_db:6.1f} {rec.utilization:5.2f} "
              f"{rec.eff_tops_per_w:7.0f} {rec.macro_count_for_rate:15d}")


if __name__ == "__main__":
    main()
