"""House-rules linter of the PyTorch port: kernel-path purity, lock
discipline, schema drift over `src/repro_torch`.

Runs the `repro_torch.analysis` passes and prints findings as
``path:line: [rule] message``.  Exit status is the number of kept
findings (capped at 125), so a CI step can gate on it directly.  The
flags are `tools/repro_lint.py`'s.

  python tools/repro_torch_lint.py                 # all passes
  python tools/repro_torch_lint.py --strict        # + reasonless/unused suppressions
  python tools/repro_torch_lint.py --pass locks    # one pass family
  python tools/repro_torch_lint.py --update-manifest   # regenerate the manifest
  python tools/repro_torch_lint.py --list-rules    # rule catalog

Suppression syntax (docs/torch_static_analysis.md):

  n = int(x.max())   # lint: disable=host-sync -- sizes the launch
"""
from __future__ import annotations

import argparse
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.analysis import (INERT_RULES, RULES,  # noqa: E402
                                  apply_suppressions, load_tree,
                                  lock_discipline, schema_drift,
                                  trace_purity)

PASSES = ("locks", "schema", "trace")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch_lint",
        description="kernel-path purity / lock-discipline / schema-drift "
                    "linter of src/repro_torch")
    ap.add_argument("--root", type=pathlib.Path, default=REPO,
                    help="repo root to scan (default: this checkout)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail reasonless, unknown-rule, or unused "
                         "suppressions")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASSES,
                    help="run only this pass family (repeatable; "
                         "default: all)")
    ap.add_argument("--update-manifest", action="store_true",
                    help="regenerate the committed schema manifest from "
                         "the live tree and exit")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print findings silenced by lint: disable "
                         "comments")
    args = ap.parse_args(argv)

    if args.list_rules:
        width = max(len(r) for r in (*RULES, *INERT_RULES))
        for rule in sorted(RULES):
            print(f"{rule:<{width}}  {RULES[rule]}")
        for rule in sorted(INERT_RULES):
            print(f"{rule:<{width}}  not checked: {INERT_RULES[rule]}")
        return 0

    root = args.root.resolve()
    modules = load_tree(root)
    if not modules:
        print(f"repro_torch_lint: no modules under {root}/src/repro_torch",
              file=sys.stderr)
        return 1

    if args.update_manifest:
        path = schema_drift.write_manifest(root, modules)
        print(f"wrote {path.relative_to(root)}")
        return 0

    wanted = args.passes or PASSES
    findings = []
    if "trace" in wanted:
        findings.extend(trace_purity.run(modules))
    if "locks" in wanted:
        findings.extend(lock_discipline.run(modules))
    if "schema" in wanted:
        findings.extend(schema_drift.run(modules, root=root))

    kept, suppressed = apply_suppressions(findings, modules,
                                          strict=args.strict)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    for f in kept:
        print(f.render())
    if args.show_suppressed:
        for f in suppressed:
            print(f"suppressed: {f.render()}")
    tail = f"{len(kept)} finding(s)"
    if suppressed:
        tail += f", {len(suppressed)} suppressed"
    print(f"repro_torch_lint: {tail} over {len(modules)} modules"
          + (" [strict]" if args.strict else ""))
    return min(len(kept), 125)


if __name__ == "__main__":
    raise SystemExit(main())
