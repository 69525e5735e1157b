"""House-rules static analysis of the port: kernel-path purity, lock
discipline, schema drift.

Counterpart of the JAX package's `analysis` package, pointed at
`src/repro_torch`.  CLI front end: ``tools/repro_torch_lint.py``; rule
catalog and suppression syntax: ``docs/torch_static_analysis.md``.
Rules (``tools/repro_torch_lint.py --list-rules``):

  * ``host-sync``, ``host-guard`` (`trace_purity`): no host sync on a
    kernel entry function's device path; the plain version only behind
    a CPU-device fence, never from an ``except``;
  * ``unguarded-attr``, ``lock-order``, ``lock-reacquire``
    (`lock_discipline`), as the reference's;
  * ``schema-drift``, ``manifest-stale`` (`schema_drift`), against
    `src/repro_torch/analysis/schema_manifest.json`, which equals the
    reference's;
  * ``bad-suppression`` (`core.apply_suppressions` under ``strict``).

The reference's ``host-call``, ``inplace-store`` and ``set-iteration``
guard a jit tracer and are not checked (`core.INERT_RULES`).
"""
from repro_torch.analysis.core import (INERT_RULES, RULES, Finding, Module,
                                       apply_suppressions, load_tree)
from repro_torch.analysis import lock_discipline, schema_drift, trace_purity

__all__ = ["Finding", "INERT_RULES", "Module", "RULES", "apply_suppressions",
           "load_tree", "run_all", "lock_discipline", "schema_drift",
           "trace_purity"]


def run_all(root, modules=None, *, strict=False):
    """Run every pass over ``root`` and return (kept, suppressed)."""
    import pathlib

    root = pathlib.Path(root)
    if modules is None:
        modules = load_tree(root)
    findings = []
    findings.extend(trace_purity.run(modules))
    findings.extend(lock_discipline.run(modules))
    findings.extend(schema_drift.run(modules, root=root))
    return apply_suppressions(findings, modules, strict=strict)
