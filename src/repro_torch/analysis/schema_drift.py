"""Schema-drift pass: serialized shapes cannot change without a bump.

Counterpart of the JAX package's pass over `src/repro_torch`.  The port
reads and writes the reference's artifact cache and traces, so its
committed manifest equals the reference's field for field and version
for version; a difference is a fault of the port.

The repo stamps three wire formats with integer schema versions:

  * ``ARTIFACT_SCHEMA`` (`repro_torch.api.session`) — `DesignArtifact.to_dict`
    payloads plus the `Provenance` dataclass columns;
  * ``TRACE_SCHEMA`` (`repro_torch.telemetry.spans`) — `TraceExport.to_dict`
    Chrome-trace envelopes;
  * ``METRICS_SCHEMA`` (`repro_torch.telemetry.metrics`) — registry snapshot
    envelopes and per-metric dicts.

This pass extracts each format's
*field set* straight from the AST — every string key of a dict literal
or ``d["k"] = v`` store inside the serializer, and every dataclass
field — and diffs it against the committed manifest
(`src/repro_torch/analysis/schema_manifest.json`):

  * fields changed while the version constant did not -> **schema-drift**
    (bump the constant, then regenerate);
  * version constant changed but the manifest still records the old
    version -> **manifest-stale** (regenerate via
    ``tools/repro_torch_lint.py --update-manifest``).
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib

from repro_torch.analysis.core import Finding, Module

MANIFEST_PATH = "src/repro_torch/analysis/schema_manifest.json"


@dataclasses.dataclass(frozen=True)
class Spec:
    key: str                 # manifest key
    module: str              # dotted module holding the format
    version_const: str       # module-level int constant
    sources: tuple[str, ...]  # "Class.method" (dict keys) or "Class" (fields)


SPECS = (
    Spec("artifact", "repro_torch.api.session", "ARTIFACT_SCHEMA",
         ("DesignArtifact.to_dict", "Provenance")),
    Spec("trace", "repro_torch.telemetry.spans", "TRACE_SCHEMA",
         ("TraceExport.to_dict", "TraceExport.to_events")),
    Spec("metrics", "repro_torch.telemetry.metrics", "METRICS_SCHEMA",
         ("MetricsRegistry.snapshot", "Counter.to_dict",
          "Histogram.to_dict")),
)


def _class_node(mod: Module, name: str) -> ast.ClassDef | None:
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _method_node(cls: ast.ClassDef, name: str) -> ast.FunctionDef | None:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _dict_keys(fn: ast.FunctionDef) -> set[str]:
    """Every literal string key the serializer emits: dict-literal keys
    plus ``d["k"] = v`` subscript stores (nested dicts included — a
    nested field is as much wire format as a top-level one)."""
    keys: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            tgts = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in tgts:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.slice, ast.Constant) and \
                        isinstance(t.slice.value, str):
                    keys.add(t.slice.value)
    return keys


def _dataclass_fields(cls: ast.ClassDef) -> set[str]:
    return {n.target.id for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)}


def _version_const(mod: Module, name: str) -> tuple[int | None, int]:
    """(value, line) of a module-level integer constant."""
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == name and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, int):
            return node.value.value, node.lineno
    return None, 1


def extract(modules: dict[str, Module]) -> dict[str, dict]:
    """Live schema state: {key: {"version": int, "fields": [..]}}."""
    out: dict[str, dict] = {}
    for spec in SPECS:
        mod = modules.get(spec.module)
        if mod is None:
            continue
        version, _ = _version_const(mod, spec.version_const)
        fields: set[str] = set()
        for src in spec.sources:
            cls_name, _, meth_name = src.partition(".")
            cls = _class_node(mod, cls_name)
            if cls is None:
                continue
            if meth_name:
                fn = _method_node(cls, meth_name)
                if fn is not None:
                    fields |= {f"{src}:{k}" for k in _dict_keys(fn)}
            else:
                fields |= {f"{src}:{k}" for k in _dataclass_fields(cls)}
        out[spec.key] = {"version": version, "fields": sorted(fields)}
    return out


def load_manifest(root: pathlib.Path) -> dict | None:
    path = root / MANIFEST_PATH
    if not path.exists():
        return None
    return json.loads(path.read_text())


def write_manifest(root: pathlib.Path,
                   modules: dict[str, Module]) -> pathlib.Path:
    path = root / MANIFEST_PATH
    path.write_text(json.dumps(extract(modules), indent=2,
                               sort_keys=True) + "\n")
    return path


def run(modules: dict[str, Module], *,
        root: pathlib.Path) -> list[Finding]:
    manifest = load_manifest(root)
    findings: list[Finding] = []
    if manifest is None:
        findings.append(Finding(
            "manifest-stale", MANIFEST_PATH, 1,
            "schema manifest missing; generate it with "
            "tools/repro_torch_lint.py --update-manifest"))
        return findings
    live = extract(modules)
    for spec in SPECS:
        mod = modules.get(spec.module)
        if mod is None:
            continue
        state = live.get(spec.key, {})
        version, line = state.get("version"), 1
        _, line = _version_const(mod, spec.version_const)
        committed = manifest.get(spec.key)
        if version is None:
            findings.append(Finding(
                "schema-drift", mod.rel, 1,
                f"{spec.version_const} constant not found in "
                f"{spec.module}; schema formats must carry a version"))
            continue
        if committed is None:
            findings.append(Finding(
                "manifest-stale", MANIFEST_PATH, 1,
                f"manifest has no entry for {spec.key!r}; regenerate "
                f"with --update-manifest"))
            continue
        if version != committed.get("version"):
            findings.append(Finding(
                "manifest-stale", mod.rel, line,
                f"{spec.version_const}={version} but the committed "
                f"manifest records version {committed.get('version')}; "
                f"regenerate with tools/repro_torch_lint.py --update-manifest"))
            continue
        added = sorted(set(state["fields"]) - set(committed["fields"]))
        removed = sorted(set(committed["fields"]) - set(state["fields"]))
        if added or removed:
            delta = "; ".join(
                s for s in (f"added {added}" if added else "",
                            f"removed {removed}" if removed else "") if s)
            findings.append(Finding(
                "schema-drift", mod.rel, line,
                f"serialized fields of {spec.key!r} changed without a "
                f"{spec.version_const} bump ({delta}); bump the version "
                f"and rerun --update-manifest"))
    return findings
