"""Shared infrastructure for the port's house-rules static analysis.

Counterpart of the JAX package's `analysis.core`, pointed at
`src/repro_torch`.  The `repro_torch.analysis` package checks, by
machine, three invariant families of the port (rule catalog:
`docs/torch_static_analysis.md`):

  * **kernel-path purity** (`repro_torch.analysis.trace_purity`) — no
    host sync on the device path of a kernel family's `kernel.py` /
    `ops.py` entry functions, and no way from those modules into the
    plain version (`ref.py`) other than behind a CPU-device fence;
  * **lock discipline** (`repro_torch.analysis.lock_discipline`) —
    instance attributes written from more than one thread root must be
    accessed under a lock, and lock acquisition orders must not invert;
  * **schema drift** (`repro_torch.analysis.schema_drift`) — serialized
    field sets must match the committed per-version manifest, which
    equals the JAX package's (the two packages read each other's
    artifacts and traces).

This module holds what every pass shares: the `Finding` record, module
loading (path -> parsed AST with stable dotted names), and the
suppression-comment machinery.

Suppression syntax (one line, trailing or the line directly above the
flagged statement)::

    n = int(x.max())   # lint: disable=host-sync -- sizes the launch

    # lint: disable-file=unguarded-attr -- single-threaded test helper

A suppression MUST carry a ``-- reason`` tail: `--strict` turns both a
reasonless disable and an *unused* disable into findings of their own,
so the suppression inventory stays justified and live.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

# Every rule id a pass can emit.  The CLI validates suppressions against
# this set so a typo'd disable comment fails loudly instead of silently
# suppressing nothing.
RULES = {
    "host-sync": "host sync on the device path of a kernel entry function",
    "host-guard": "kernels/*/kernel.py or ops.py reaches the plain version "
                  "(ref.py) outside a CPU-device fence, or from an except",
    "unguarded-attr": "attribute written from >1 thread root accessed "
                      "outside its lock",
    "lock-order": "lock-order inversion (cycle in the acquisition graph)",
    "lock-reacquire": "non-reentrant lock (or an alias) re-acquired while "
                      "already held",
    "schema-drift": "serialized fields changed without a schema bump",
    "manifest-stale": "schema version bumped but the committed manifest "
                      "was not regenerated",
    "bad-suppression": "malformed, reasonless, or unused lint suppression",
}

# The JAX package's rules that guard a jit tracer and mean nothing under
# eager PyTorch: no pass emits them, and a suppression naming one is
# reported under --strict with the reason.
INERT_RULES = {
    "host-call": "no tracer bakes a host value into a compiled program: "
                 "the Python between launches runs on every call, so a "
                 "clock read, a print or the first call's nvcc build is "
                 "host time, not a wrong result (host syncs: host-sync)",
    "inplace-store": "torch tensors are mutable and an eager `t[i] = v` "
                     "writes what it says; no trace replays it and there "
                     "is no retrace count to disturb",
    "set-iteration": "eager PyTorch has no trace structure for a set's "
                     "order to destabilise; each call runs its ops anew",
}

_DISABLE_RE = re.compile(
    r"#\s*lint:\s*(disable|disable-file)\s*=\s*"
    r"(?P<rules>[\w,\s-]+?)\s*(?:--\s*(?P<reason>.*\S))?\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, printable as ``path:line: [rule] message``."""

    rule: str
    path: str          # repo-relative, '/'-separated
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    path: str
    line: int          # 0 for file-level
    rule: str
    reason: str | None
    file_level: bool


@dataclasses.dataclass
class Module:
    """One parsed source file: dotted name, AST, and raw lines."""

    name: str          # dotted ("repro_torch.serve.design_service")
    path: pathlib.Path
    rel: str           # repo-relative, '/'-separated
    tree: ast.Module
    lines: list[str]

    @property
    def suppressions(self) -> list[Suppression]:
        out = []
        for i, text in self._comments():
            m = _DISABLE_RE.search(text)
            if m is None:
                continue
            file_level = m.group(1) == "disable-file"
            for rule in re.split(r"[,\s]+", m.group("rules")):
                if rule:
                    out.append(Suppression(
                        path=self.rel, line=0 if file_level else i,
                        rule=rule, reason=m.group("reason"),
                        file_level=file_level))
        return out

    def _comments(self) -> list[tuple[int, str]]:
        """(line, text) of real COMMENT tokens — a docstring that merely
        *shows* the disable syntax is not a suppression."""
        import io
        import tokenize

        out: list[tuple[int, str]] = []
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO("\n".join(self.lines) + "\n").readline):
                if tok.type == tokenize.COMMENT:
                    out.append((tok.start[0], tok.string))
        except (tokenize.TokenizeError, IndentationError, SyntaxError):
            return [(i, t) for i, t in enumerate(self.lines, 1)
                    if "#" in t]
        return out


def parse_file(path: pathlib.Path, *, root: pathlib.Path,
               name: str | None = None) -> Module:
    text = path.read_text()
    rel = path.relative_to(root).as_posix()
    if name is None:
        parts = list(path.relative_to(root).with_suffix("").parts)
        if parts and parts[0] == "src":
            parts = parts[1:]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        name = ".".join(parts)
    return Module(name=name, path=path, rel=rel,
                  tree=ast.parse(text, filename=str(path)),
                  lines=text.splitlines())


def load_tree(root: pathlib.Path,
              subdirs: tuple[str, ...] = ("src/repro_torch",),
              ) -> dict[str, Module]:
    """Parse every ``*.py`` under ``root/<subdir>`` into a name-keyed
    module map (the unit all passes operate on)."""
    modules: dict[str, Module] = {}
    for sub in subdirs:
        base = root / sub
        for path in sorted(base.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            mod = parse_file(path, root=root)
            modules[mod.name] = mod
    return modules


def apply_suppressions(findings: list[Finding],
                       modules: dict[str, Module], *,
                       strict: bool = False
                       ) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (kept, suppressed).

    A finding is suppressed by a file-level disable of its rule, or a
    line-level disable on the finding's line or the line directly above
    it.  Under ``strict``, a suppression with no ``-- reason`` tail, an
    unknown rule id, or one that suppressed nothing becomes a
    `bad-suppression` finding in the kept list.
    """
    by_path: dict[str, list[Suppression]] = {}
    for mod in modules.values():
        by_path.setdefault(mod.rel, []).extend(mod.suppressions)

    kept: list[Finding] = []
    suppressed: list[Finding] = []
    used: set[tuple[str, int, str]] = set()
    for f in findings:
        hit = None
        for s in by_path.get(f.path, ()):
            if s.rule != f.rule:
                continue
            if s.file_level or s.line in (f.line, f.line - 1):
                hit = s
                break
        if hit is None:
            kept.append(f)
        else:
            used.add((hit.path, hit.line, hit.rule))
            suppressed.append(f)

    if strict:
        for sups in by_path.values():
            for s in sups:
                if s.rule in INERT_RULES:
                    kept.append(Finding(
                        "bad-suppression", s.path, s.line or 1,
                        f"rule {s.rule!r} is not checked under eager "
                        f"PyTorch: {INERT_RULES[s.rule]}"))
                elif s.rule not in RULES:
                    kept.append(Finding(
                        "bad-suppression", s.path, s.line or 1,
                        f"unknown rule {s.rule!r} in disable comment"))
                elif not s.reason:
                    kept.append(Finding(
                        "bad-suppression", s.path, s.line or 1,
                        f"suppression of {s.rule!r} has no '-- reason' "
                        f"tail; justify it inline"))
                elif (s.path, s.line, s.rule) not in used:
                    kept.append(Finding(
                        "bad-suppression", s.path, s.line or 1,
                        f"suppression of {s.rule!r} matched no finding; "
                        f"remove it"))
    return kept, suppressed


# -- small AST helpers shared by the passes -----------------------------
def dotted(node: ast.expr) -> str | None:
    """``a.b.c`` attribute/name chain as a string, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_map(tree: ast.Module) -> dict[str, str]:
    """Top-level import bindings: local alias -> dotted origin.

    ``import a.b as c``      -> {"c": "a.b"}
    ``import a.b``           -> {"a": "a"}   (binding is the root name)
    ``from a.b import c``    -> {"c": "a.b.c"}
    ``from .x import y``     -> {"y": ".x.y"}  (leading dots preserved)
    """
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    out[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            for a in node.names:
                out[a.asname or a.name] = (f"{base}.{a.name}"
                                           if base else a.name)
    return out
