"""Roofline aggregation: reads the dry-run's records
(`launch.dryrun.run_cell`, `runs/dryrun_torch/*.json`) into tables (per
arch x shape x mesh: three terms, dominant bottleneck, MODEL_FLOPS
ratio, fit).

Counterpart of `benchmarks/roofline.py`, with its columns, but
`fits_80gb` (the H100's HBM) in place of `fits_16gb`, and a
`collective_s` that is `null` where the dry-run does not model it (links
between nodes).  With no records it prints one line saying so.

  PYTHONPATH=src python -m repro_torch.paper.roofline [--runs DIR]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.dryrun import RUNS

HEADER = ("arch,shape,status,compute_s,memory_s,collective_s,dominant,"
          "bytes_per_dev_GB,fits_80gb,useful_ratio,roofline_frac,"
          "model_gflops")


def rows(mesh: str | None = "pod16x16", variant: str = "",
         runs=None) -> list[dict]:
    """The records of `mesh` (every mesh where None) and `variant` ("" or
    "perf") in `runs` (default `launch.dryrun.RUNS`)."""
    out = []
    for f in sorted(pathlib.Path(runs or RUNS).glob("*.json")):
        is_perf = "__perf" in f.name
        if bool(variant) != is_perf:
            continue
        r = json.loads(f.read_text())
        if mesh and r.get("mesh") != mesh:
            continue
        out.append(r)
    return out


def _e(x) -> str:
    return "null" if x is None else f"{x:.3e}"


def table(mesh: str = "pod16x16", variant: str = "", runs=None) -> str:
    """The CSV table of `rows(mesh, variant, runs)`, one line a record."""
    lines = [HEADER]
    for r in rows(mesh, variant, runs):
        if r["status"] != "ok":
            lines.append(f"{r['arch']},{r['shape']},{r['status']},,,,,,,,")
            continue
        ro, m = r["roofline"], r["memory"]
        lines.append(
            f"{r['arch']},{r['shape']},ok,"
            f"{ro['compute_s']:.3e},{ro['memory_s']:.3e},"
            f"{_e(ro['collective_s'])},{ro['dominant'].replace('_s','')},"
            f"{m['total_bytes']/1e9:.2f},{m['fits_80gb']},"
            f"{ro['useful_flops_ratio']:.3f},{ro['roofline_fraction']:.3f},"
            f"{ro['model_flops_global']/1e9:.0f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default=None,
                    help=f"the records' directory (default {RUNS})")
    args = ap.parse_args(argv)
    if not rows(None, "", args.runs) and not rows(None, "perf", args.runs):
        print(f"no dry-run records in {args.runs or RUNS} "
              f"(python -m repro_torch.launch.dryrun --all writes them)")
        return
    for mesh in ("pod16x16", "pod2x16x16"):
        print(f"== mesh {mesh} ==")
        print(table(mesh, runs=args.runs))
    perf = table("pod16x16", variant="perf", runs=args.runs).splitlines()
    if len(perf) > 1:
        print("== §Perf hillclimb variants (pod16x16) ==")
        print("\n".join(perf))


if __name__ == "__main__":
    main()
