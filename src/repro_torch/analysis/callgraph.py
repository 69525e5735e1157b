"""Project-wide call graph rooted at the kernel families' entry functions.

Counterpart of the JAX package's `analysis.callgraph`.  Eager PyTorch
has no tracer, so the roots are not trace regions: they are the public
top-level functions of every kernel family's wrapper and entry modules
(``repro_torch.kernels.<family>.kernel`` and ``.ops``), and the graph
follows everything they call inside `repro_torch`.  That is the code a
call on the card runs between its launches.

Built from ASTs alone (nothing is imported).  Edges follow direct
calls: bare names (nested defs, then module globals), ``from x import
f`` bindings, and ``mod.f`` where ``mod`` is an imported project module.
Method calls through objects are not resolved (a conservative
under-approximation: the passes flag what they can prove, never guess).

**CPU-fence pruning.**  A wrapper runs the plain version only for
tensors on the CPU (``if x.device.type == "cpu": return ref.f(...)``).
Statements under such a fence are *plain-only*: a call on the card
cannot reach them, so calls there do not extend reachability.  The
fence is an ``if`` whose test compares an expression's ``.type`` with
``"cpu"``: with ``==`` (alone or as a conjunct of ``and``) its body is
plain-only; with ``!=`` its ``else`` is, and so is the rest of the
block when the body always leaves (``return`` / ``raise``).
`repro_torch.analysis.trace_purity` checks separately that every call
into a family's ``ref`` module sits behind one.
"""
from __future__ import annotations

import ast
import dataclasses
import re

from repro_torch.analysis.core import Module, dotted, import_map

# Modules whose public top-level functions root the graph.
ROOT_MODULE_RE = re.compile(r"repro_torch\.kernels\.\w+\.(kernel|ops)$")


def is_root_module(name: str) -> bool:
    return ROOT_MODULE_RE.fullmatch(name) is not None


@dataclasses.dataclass
class CallSite:
    node: ast.Call
    norm: str | None       # normalized dotted target ("torch.cuda.foo")
    fid: str | None        # resolved project function id, if any
    plain_only: bool       # lexically behind a CPU-device fence
    in_except: bool        # inside an ``except`` handler


@dataclasses.dataclass
class FuncInfo:
    fid: str               # "module.name:qualname"
    module: Module
    qualname: str
    node: ast.AST          # FunctionDef / AsyncFunctionDef / Lambda
    calls: list[CallSite] = dataclasses.field(default_factory=list)
    root: str | None = None    # why this function roots the graph


def _cpu_compare(node: ast.expr) -> str | None:
    """"eq" / "ne" if ``node`` is ``<expr>.type ==/!= "cpu"``."""
    if not (isinstance(node, ast.Compare) and len(node.ops) == 1):
        return None
    sides = (node.left, node.comparators[0])
    if not any(isinstance(s, ast.Attribute) and s.attr == "type"
               for s in sides):
        return None
    if not any(isinstance(s, ast.Constant) and s.value == "cpu"
               for s in sides):
        return None
    if isinstance(node.ops[0], ast.Eq):
        return "eq"
    if isinstance(node.ops[0], ast.NotEq):
        return "ne"
    return None


def cpu_fence(stmt: ast.stmt) -> str | None:
    """How an ``if`` fences the plain version: "body" (its body runs only
    for CPU tensors), "else" (its else branch does, and the rest of the
    block when the body always leaves), or None."""
    if not isinstance(stmt, ast.If):
        return None
    test = stmt.test
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        if any(_cpu_compare(v) == "eq" for v in test.values):
            return "body"
        return None
    kind = _cpu_compare(test)
    if kind == "eq":
        return "body"
    if kind == "ne":
        return "else"
    return None


def _always_leaves(stmts: list[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(stmts[-1], (ast.Return, ast.Raise))


class CallGraph:
    def __init__(self, modules: dict[str, Module]):
        self.modules = modules
        self.functions: dict[str, FuncInfo] = {}
        self._module_scope: dict[str, dict[str, str]] = {}  # mod -> name->fid
        self._imports: dict[str, dict[str, str]] = {}
        for mod in modules.values():
            self._imports[mod.name] = import_map(mod.tree)
            self._collect(mod)
        for mod in modules.values():
            self._link(mod)

    # -- pass 1: enumerate functions, mark the roots -------------------
    def _collect(self, mod: Module) -> None:
        scope: dict[str, str] = {}
        self._module_scope[mod.name] = scope
        root_mod = is_root_module(mod.name)

        def walk(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    fid = f"{mod.name}:{qual}"
                    info = FuncInfo(fid, mod, qual, child)
                    self.functions[fid] = info
                    if not prefix:
                        scope[child.name] = fid
                        if root_mod and not child.name.startswith("_"):
                            info.root = f"entry {mod.name}.{child.name}"
                    walk(child, qual + ".")
                elif isinstance(child, ast.ClassDef):
                    walk(child, f"{prefix}{child.name}.")
                elif isinstance(child, ast.Lambda):
                    qual = f"{prefix}<lambda@{child.lineno}>"
                    fid = f"{mod.name}:{qual}"
                    self.functions[fid] = FuncInfo(fid, mod, qual, child)
                    walk(child, qual + ".")
                else:
                    walk(child, prefix)

        walk(mod.tree, "")

    # -- name resolution ----------------------------------------------
    def _resolve_module(self, here: str, target: str) -> str:
        """Resolve a possibly-relative dotted module path."""
        if not target.startswith("."):
            return target
        level = len(target) - len(target.lstrip("."))
        base = here.split(".")
        base = base[:-1] if len(base) >= level else []
        base = base[: len(base) - (level - 1)] if level > 1 else base
        rest = target.lstrip(".")
        return ".".join(base + ([rest] if rest else []))

    def _resolve_name(self, mod: Module, scope_chain: list[str],
                      name: str) -> tuple[str | None, str | None]:
        """A bare name -> (project fid, normalized dotted), best effort."""
        for outer in reversed(scope_chain):
            fid = f"{mod.name}:{outer}.{name}" if outer else None
            if fid and fid in self.functions:
                return fid, None
        fid = self._module_scope[mod.name].get(name)
        if fid:
            return fid, None
        origin = self._imports[mod.name].get(name)
        if origin:
            origin = self._resolve_module(mod.name, origin)
            head, _, tail = origin.rpartition(".")
            if head in self.modules and f"{head}:{tail}" in self.functions:
                return f"{head}:{tail}", origin
            return None, origin
        return None, name    # builtin / unknown global

    def resolve_call(self, mod: Module, scope_chain: list[str],
                     call: ast.Call) -> tuple[str | None, str | None]:
        name = dotted(call.func)
        if name is None:
            return None, None
        if "." not in name:
            return self._resolve_name(mod, scope_chain, name)
        root, _, rest = name.partition(".")
        origin = self._imports[mod.name].get(root)
        if origin is None:
            return None, name            # e.g. self.x(), obj.m()
        origin = self._resolve_module(mod.name, origin)
        norm = f"{origin}.{rest}"
        head, _, tail = norm.rpartition(".")
        if head in self.modules and f"{head}:{tail}" in self.functions:
            return f"{head}:{tail}", norm
        return None, norm

    # -- pass 2: edges -------------------------------------------------
    def _link(self, mod: Module) -> None:
        graph = self

        def func_of(scope_chain: list[str]) -> FuncInfo | None:
            if not scope_chain:
                return None
            return graph.functions.get(f"{mod.name}:{scope_chain[-1]}")

        def visit_block(stmts: list[ast.stmt], scope_chain: list[str],
                        plain: bool, exc: bool) -> None:
            fenced = plain
            for stmt in stmts:
                fence = cpu_fence(stmt)
                if fence is None:
                    visit_node(stmt, scope_chain, fenced, exc)
                    continue
                visit_node(stmt.test, scope_chain, fenced, exc)
                visit_block(stmt.body, scope_chain,
                            fenced or fence == "body", exc)
                visit_block(stmt.orelse, scope_chain,
                            fenced or fence == "else", exc)
                if fence == "else" and _always_leaves(stmt.body):
                    fenced = True

        def visit_node(node: ast.AST, scope_chain: list[str], plain: bool,
                       exc: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = (f"{scope_chain[-1]}.{node.name}" if scope_chain
                        else node.name)
                for dec in node.decorator_list:
                    visit_node(dec, scope_chain, plain, exc)
                visit_block(node.body, scope_chain + [qual], False, False)
                return
            if isinstance(node, ast.ClassDef):
                qual = (f"{scope_chain[-1]}.{node.name}" if scope_chain
                        else node.name)
                visit_block(node.body, scope_chain[:-1] + [qual]
                            if scope_chain else [qual], plain, exc)
                return
            if isinstance(node, ast.Lambda):
                qual = (f"{scope_chain[-1]}.<lambda@{node.lineno}>"
                        if scope_chain else f"<lambda@{node.lineno}>")
                visit_node(node.body, scope_chain + [qual], plain, exc)
                return
            if isinstance(node, ast.Call):
                fid, norm = graph.resolve_call(mod, scope_chain, node)
                info = func_of(scope_chain)
                if info is not None:
                    info.calls.append(CallSite(node, norm, fid, plain, exc))
            if isinstance(node, ast.ExceptHandler):
                visit_block(node.body, scope_chain, plain, True)
                return
            for stmt_field in ("body", "orelse", "finalbody"):
                block = getattr(node, stmt_field, None)
                if (isinstance(block, list) and block
                        and isinstance(block[0], ast.stmt)):
                    visit_block(block, scope_chain, plain, exc)
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    continue               # handled by the block visitor
                visit_node(child, scope_chain, plain, exc)

        visit_block(mod.tree.body, [], False, False)

    # -- reachability ---------------------------------------------------
    def device_reachable(self, stop=lambda fid: False) -> dict[str, str]:
        """fid -> provenance ("root: ..." or "via <caller fid>") for every
        function a call on the card can reach from a root.  Plain-only
        (CPU-fenced) call sites do not extend reachability, nor do calls
        into a function for which ``stop(fid)`` holds."""
        frontier = [(fid, f"root: {info.root}")
                    for fid, info in self.functions.items()
                    if info.root is not None]
        seen: dict[str, str] = {}
        while frontier:
            fid, why = frontier.pop()
            if fid in seen:
                continue
            seen[fid] = why
            for site in self.functions[fid].calls:
                if site.plain_only or site.fid is None or stop(site.fid):
                    continue
                if site.fid not in seen:
                    frontier.append((site.fid, f"via {fid}"))
        return seen
