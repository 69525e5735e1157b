"""Docs link & code-reference checker of the PyTorch port (stdlib only).

The checks of `tools/check_docs.py`, over README.md, ROADMAP.md, PERF.md
and docs/*.md:

  1. Relative markdown links `[text](target)` point at files that exist
     (http(s) URLs and pure #anchors are skipped).
  2. Inline-code path references — backtick spans that look like repo
     paths (contain "/" and a known suffix, or start with a top-level
     repo directory) — resolve against the repo root, `src/repro/` or
     `src/repro_torch/`.
  3. Inline-code module references starting with `repro.` or
     `repro_torch.` resolve to a module/package under src/.  A trailing
     attribute segment is allowed (`repro_torch.core.explorer.explore`
     passes because `src/repro_torch/core/explorer.py` exists), and so
     is a CapWord class segment followed by one attribute
     (`repro_torch.api.DesignSession.run_many`).

Exit status is the number of broken references (capped at 125); each is
printed as `file:line: message`.

  python tools/check_docs_torch.py [--root DIR]
"""
from __future__ import annotations

import argparse
import pathlib
import re
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

LINK_RE = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")
CODE_RE = re.compile(r"`([^`\n]+)`")
PATH_SUFFIXES = (".py", ".md", ".json", ".yml", ".yaml", ".toml", ".txt")
LOCATED_RE = re.compile(
    r"(?P<path>[^:]+)(?::(?P<a>\d+)(?:-(?P<b>\d+))?|::[\w\[\].-]+)?")
TOP_DIRS = ("src/", "tests/", "examples/", "benchmarks/", "docs/",
            "tools/", ".github/")


def doc_files() -> list[pathlib.Path]:
    return ([REPO / name for name in ("README.md", "ROADMAP.md", "PERF.md")
             if (REPO / name).exists()]
            + sorted((REPO / "docs").glob("*.md")))


def check_link(md: pathlib.Path, target: str) -> str | None:
    if target.startswith(("http://", "https://", "mailto:", "#")):
        return None
    path = (md.parent / target.split("#")[0]).resolve()
    if not path.exists():
        return f"broken link target: {target}"
    return None


def looks_like_path(span: str) -> bool:
    if any(ch in span for ch in " `$<>|,(){}*"):
        return False
    return (span.startswith(TOP_DIRS)
            or ("/" in span and span.endswith(PATH_SUFFIXES)))


def check_path_ref(span: str) -> str | None:
    # A path may carry a line (`f.py:12`), a line range (`f.py:12-30`) or
    # a test id (`tests/t.py::test_x`); the lines must lie in the file.
    m = LOCATED_RE.fullmatch(span)
    path, first, last = m.group("path"), m.group("a"), m.group("b")
    # module files are conventionally written relative to src/repro/,
    # src/repro_torch/ or src/
    for base in (REPO, REPO / "src" / "repro", REPO / "src" / "repro_torch",
                 REPO / "src"):
        if (base / path).exists():
            break
    else:
        return f"missing path reference: {span}"
    if first is not None:
        n = len((base / path).read_text().splitlines())
        if int(last or first) > n or int(first) > int(last or first):
            return (f"line reference {span}: {path} has {n} lines")
    return None


def check_module_ref(span: str) -> str | None:
    parts = span.split(".")
    # longest prefix that resolves to a module file or package dir; the
    # tail may be one attribute, or a CapWord class plus one attribute
    # (`repro.api.DesignSession.run_many`)
    for n in range(len(parts), 0, -1):
        base = REPO / "src" / pathlib.Path(*parts[:n])
        if base.with_suffix(".py").exists() or (base / "__init__.py").exists():
            tail = parts[n:]
            if len(tail) > 2 or (len(tail) == 2 and not tail[0][:1].isupper()):
                return (f"module reference {span}: {'.'.join(parts[:n])} "
                        f"exists but {'.'.join(tail)} nests too deep")
            return None
    return f"unresolvable module reference: {span}"


def main(argv: list[str] | None = None) -> int:
    global REPO
    ap = argparse.ArgumentParser(prog="check_docs_torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[1],
                    help="repo root to check (default: this checkout)")
    REPO = ap.parse_args(argv).root.resolve()
    failures = 0
    for md in doc_files():
        for ln, line in enumerate(md.read_text().splitlines(), 1):
            for target in LINK_RE.findall(line):
                msg = check_link(md, target)
                if msg:
                    print(f"{md.relative_to(REPO)}:{ln}: {msg}")
                    failures += 1
            for span in CODE_RE.findall(line):
                msg = None
                if looks_like_path(span):
                    msg = check_path_ref(span)
                elif re.fullmatch(r"repro(_torch)?(\.\w+)+", span):
                    msg = check_module_ref(span)
                if msg:
                    print(f"{md.relative_to(REPO)}:{ln}: {msg}")
                    failures += 1
    n = len(doc_files())
    print(f"checked {n} docs, {failures} broken reference(s)")
    return min(failures, 125)


if __name__ == "__main__":
    sys.exit(main())
