"""Lock-discipline pass: shared-attribute guarding and lock ordering.

Counterpart of the JAX package's pass of the same name over
`src/repro_torch`: the same rules, thread roots and messages.  A lock is
known by its constructor's short name, so the sanitizer-aware
``make_lock`` / ``make_condition`` of `repro_torch.runtime.lock_sanitizer`
and raw ``threading.Lock()`` globals (`repro_torch.kernels.LOCK`, the
kernel wrappers' ``_LIB_LOCK`` / ``_FNS_LOCK``,
`repro_torch.kernels._build`'s ``_LOCK``) resolve alike.

**Thread roots.**  For every class the pass derives the set of
execution roots that can touch an instance concurrently:

  * each ``threading.Thread(target=self.m)`` target method;
  * each callable passed to ``run_supervised`` (runs on the *current*
    thread — it extends the enclosing root, it does not open a new one);
  * ``external`` — every public method, callable from client threads;
  * ``callback`` — any closure/lambda passed to a foreign call (metrics
    gauge ``fn=``, ticket callbacks): it runs on whatever thread samples
    it.  A closure passed through a *local wrapper* that invokes it
    under a lock (the ``locked(fn)`` gauge idiom in
    `repro_torch.serve.design_service`) inherits that lock as held-on-entry.

**unguarded-attr.**  An instance attribute written from one root and
touched from another (``__init__`` is construction time and exempt)
must have a single lock held at *every* access.  Lock identity follows
aliases: ``threading.Condition(self._lock)`` guards the same mutex as
``_lock``.  Held sets combine lexical ``with self._lock:`` scopes with a
held-on-entry fixpoint over intra-class ``self.m()`` calls, so a helper
only ever called under the lock is covered without annotation.

**lock-order / lock-reacquire.**  Globally, every acquisition performed
while another lock is held contributes an edge ``held -> acquired`` to
an acquisition graph (lock names resolve through the class that defines
them, e.g. ``DesignService._lock`` vs ``DesignSession.stats_lock``).  A
cycle is a potential deadlock (`lock-order`); acquiring a non-reentrant
lock, or an alias of it, while already held is a guaranteed one
(`lock-reacquire`).  The runtime companion
`repro_torch.runtime.lock_sanitizer` checks the same property dynamically.
"""
from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis.core import Finding, Module, dotted

# ctor short-name -> reentrant; make_lock/make_condition are the
# sanitizer-aware factories from repro_torch.runtime.lock_sanitizer
_LOCK_CTORS = {"Lock": False, "RLock": True, "Condition": False,
               "Semaphore": False, "BoundedSemaphore": False,
               "make_lock": False, "make_condition": False}
_CONDITION_CTORS = {"Condition", "make_condition"}


@dataclasses.dataclass
class LockDef:
    canonical: str        # "DesignService._lock" / "repro_torch.api.session:_GRID_SIG_LOCK"
    reentrant: bool


@dataclasses.dataclass
class Access:
    attr: str
    kind: str             # "read" | "write"
    roots: frozenset[str]
    held: frozenset[str]
    line: int
    detail: str           # method / closure description


@dataclasses.dataclass
class _Unit:
    """One analysis unit: a method body or an escaping closure."""
    name: str
    node: ast.AST
    roots: set[str]
    held_entry: set[str]


def _lock_ctor(call: ast.expr) -> tuple[bool, ast.expr | None] | None:
    """If ``call`` constructs a threading lock, return (reentrant,
    condition-wrapped-lock-expr or None)."""
    if not isinstance(call, ast.Call):
        return None
    name = dotted(call.func) or ""
    short = name.split(".")[-1]
    if short not in _LOCK_CTORS:
        return None
    wrapped = call.args[0] if short in _CONDITION_CTORS and call.args \
        else None
    return _LOCK_CTORS[short], wrapped


class _ClassInfo:
    def __init__(self, mod: Module, node: ast.ClassDef):
        self.mod = mod
        self.node = node
        self.name = node.name
        self.methods: dict[str, ast.FunctionDef] = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        self.locks: dict[str, LockDef] = {}       # attr -> def
        self._alias: dict[str, str] = {}          # attr -> aliased attr
        self._find_locks()

    def _find_locks(self) -> None:
        for meth in self.methods.values():
            for stmt in ast.walk(meth):
                if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                    continue
                tgt = stmt.targets[0]
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                ctor = _lock_ctor(stmt.value)
                if ctor is None:
                    continue
                reentrant, wrapped = ctor
                attr = tgt.attr
                wrapped_attr = None
                if wrapped is not None:
                    w = dotted(wrapped) or ""
                    if w.startswith("self."):
                        wrapped_attr = w[len("self."):]
                if wrapped_attr:
                    self._alias[attr] = wrapped_attr
                else:
                    self.locks[attr] = LockDef(
                        f"{self.name}.{attr}", reentrant)
        for attr, target in self._alias.items():
            base = self.locks.get(self.resolve_alias(target))
            self.locks[attr] = base or LockDef(f"{self.name}.{attr}", False)

    def resolve_alias(self, attr: str) -> str:
        seen = set()
        while attr in self._alias and attr not in seen:
            seen.add(attr)
            attr = self._alias[attr]
        return attr


class _Registry:
    """Global lock name resolution across modules."""

    def __init__(self, modules: dict[str, Module]):
        self.classes: list[_ClassInfo] = []
        self.module_locks: dict[str, dict[str, LockDef]] = {}
        self.by_attr: dict[str, list[LockDef]] = {}
        for mod in modules.values():
            mod_locks: dict[str, LockDef] = {}
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    info = _ClassInfo(mod, node)
                    self.classes.append(info)
                    for attr, ld in info.locks.items():
                        self.by_attr.setdefault(attr, []).append(ld)
                elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    ctor = _lock_ctor(node.value)
                    if ctor is not None:
                        name = node.targets[0].id
                        mod_locks[name] = LockDef(
                            f"{mod.name}:{name}", ctor[0])
            self.module_locks[mod.name] = mod_locks

    def resolve(self, expr: ast.expr, mod: Module,
                cls: _ClassInfo | None) -> LockDef | None:
        """Map a with-context expression to a lock definition."""
        name = dotted(expr)
        if name is None:
            return None
        if name.startswith("self.") and cls is not None:
            attr = name[len("self."):]
            if "." not in attr:
                ld = cls.locks.get(attr)
                if ld is not None:
                    return ld
        tail = name.split(".")[-1]
        if "." not in name:
            ld = self.module_locks.get(mod.name, {}).get(name)
            if ld is not None:
                return ld
        # member-object locks (self.session.stats_lock): unique-owner
        owners = self.by_attr.get(tail, [])
        canon = {o.canonical for o in owners}
        if len(canon) == 1:
            return owners[0]
        return None


def _closure_args(call: ast.Call) -> list[ast.expr]:
    return [a for a in list(call.args) + [k.value for k in call.keywords]
            if isinstance(a, (ast.Lambda, ast.Name))]


def _wrapper_held(meth: ast.FunctionDef, cls: _ClassInfo,
                  reg: _Registry, mod: Module) -> dict[str, frozenset[str]]:
    """Locally-defined wrappers that invoke a function-valued parameter
    under locks: wrapper name -> locks held at the fn() call."""
    out: dict[str, frozenset[str]] = {}
    for stmt in meth.body:
        if not isinstance(stmt, ast.FunctionDef):
            continue
        params = {a.arg for a in stmt.args.args}
        if not params:
            continue
        held_at_call: frozenset[str] | None = None

        def walk(node: ast.AST, held: frozenset[str]) -> None:
            nonlocal held_at_call
            if isinstance(node, ast.With):
                extra = set(held)
                for item in node.items:
                    ld = reg.resolve(item.context_expr, mod, cls)
                    if ld is not None:
                        extra.add(ld.canonical)
                for sub in node.body:
                    walk(sub, frozenset(extra))
                return
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in params:
                held_at_call = held if held_at_call is None \
                    else held_at_call & held
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        walk(stmt, frozenset())
        if held_at_call:
            out[stmt.name] = held_at_call
    return out


class _ClassAnalysis:
    def __init__(self, cls: _ClassInfo, reg: _Registry):
        self.cls = cls
        self.reg = reg
        self.mod = cls.mod
        self.roots: dict[str, set[str]] = {}       # method -> root names
        self.units: list[_Unit] = []
        self.accesses: list[Access] = []
        self._derive_roots()
        if len(self._all_roots()) > 1:
            self._held_entry = self._fixpoint_held_entry()
            self._collect_units()
            for unit in self.units:
                self._collect_accesses(unit)

    # -- roots ---------------------------------------------------------
    def _thread_targets(self) -> set[str]:
        targets: set[str] = set()
        for meth in self.cls.methods.values():
            for node in ast.walk(meth):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted(node.func) or ""
                if name.split(".")[-1] != "Thread":
                    continue
                for kw in node.keywords:
                    if kw.arg == "target":
                        t = dotted(kw.value) or ""
                        if t.startswith("self."):
                            targets.add(t[len("self."):])
        return targets

    def _derive_roots(self) -> None:
        thread_targets = self._thread_targets()
        self.entry_methods = thread_targets | {
            n for n in self.cls.methods if not n.startswith("_")}
        for name in self.cls.methods:
            roots: set[str] = set()
            if name in thread_targets:
                roots.add(f"thread:{name}")
            if not name.startswith("_"):
                roots.add("external")
            if roots:
                self.roots[name] = roots
        # propagate reachability over intra-class self.m() calls
        changed = True
        while changed:
            changed = False
            for name, meth in self.cls.methods.items():
                src = self.roots.get(name)
                if not src:
                    continue
                for callee in self._self_calls(meth):
                    if callee == "__init__" or callee not in self.cls.methods:
                        continue
                    dst = self.roots.setdefault(callee, set())
                    if not src <= dst:
                        dst |= src
                        changed = True

    def _all_roots(self) -> set[str]:
        out: set[str] = set()
        for r in self.roots.values():
            out |= r
        return out

    def _self_calls(self, meth: ast.AST) -> set[str]:
        out = set()
        for node in ast.walk(meth):
            if isinstance(node, ast.Call):
                name = dotted(node.func) or ""
                if name.startswith("self.") and name.count(".") == 1:
                    out.add(name[len("self."):])
                # run_supervised(self.m, ...) runs m on this thread
                if name.split(".")[-1] == "run_supervised" and node.args:
                    t = dotted(node.args[0]) or ""
                    if t.startswith("self.") and t.count(".") == 1:
                        out.add(t[len("self."):])
        return out

    # -- held-on-entry fixpoint ---------------------------------------
    def _fixpoint_held_entry(self) -> dict[str, frozenset[str]]:
        all_locks = frozenset(ld.canonical
                              for ld in self.cls.locks.values())
        # entry methods (public / thread targets) start lock-free; every
        # other method starts at ⊤ and is narrowed by its call sites
        held: dict[str, frozenset[str]] = {
            n: (frozenset() if n in self.entry_methods else all_locks)
            for n in self.cls.methods}
        for _ in range(len(self.cls.methods) + 1):
            changed = False
            for name, meth in self.cls.methods.items():
                at_sites = self._call_sites_held(meth, held.get(name,
                                                               frozenset()))
                for callee, site_held in at_sites.items():
                    if callee not in held:
                        continue
                    new = held[callee] & site_held
                    if new != held[callee]:
                        held[callee] = new
                        changed = True
            if not changed:
                break
        return held

    def _call_sites_held(self, meth: ast.FunctionDef,
                         entry: frozenset[str]) -> dict[str, frozenset[str]]:
        sites: dict[str, frozenset[str]] = {}

        def walk(node: ast.AST, held: frozenset[str]) -> None:
            if isinstance(node, ast.With):
                extra = set(held)
                for item in node.items:
                    ld = self.reg.resolve(item.context_expr, self.mod,
                                          self.cls)
                    if ld is not None:
                        extra.add(ld.canonical)
                for sub in node.body:
                    walk(sub, frozenset(extra))
                return
            if isinstance(node, ast.Call):
                name = dotted(node.func) or ""
                if name.startswith("self.") and name.count(".") == 1:
                    callee = name[len("self."):]
                    sites[callee] = sites.get(callee, held) & held
                elif name.split(".")[-1] == "run_supervised" and node.args:
                    t = dotted(node.args[0]) or ""
                    if t.startswith("self.") and t.count(".") == 1:
                        callee = t[len("self."):]
                        sites[callee] = sites.get(callee, held) & held
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        walk(meth, entry)
        return sites

    # -- units ---------------------------------------------------------
    def _collect_units(self) -> None:
        wrappers: dict[str, frozenset[str]] = {}
        for meth in self.cls.methods.values():
            wrappers.update(_wrapper_held(meth, self.cls, self.reg,
                                          self.mod))
        for name, meth in self.cls.methods.items():
            roots = self.roots.get(name, set())
            entry = set(self._held_entry.get(name, frozenset()))
            if roots and name != "__init__":
                self.units.append(_Unit(name, meth, roots, entry))
            nested = {n.name: n for n in ast.walk(meth)
                      if isinstance(n, ast.FunctionDef) and n is not meth}
            inline: set[str] = set()
            for node in ast.walk(meth):
                if not isinstance(node, ast.Call):
                    continue
                callee = dotted(node.func) or ""
                short = callee.split(".")[-1]
                if short in nested:
                    inline.add(short)       # called on this thread
                    continue
                if short == "run_supervised":
                    # run_supervised(body, ...) runs body on this thread
                    for arg in node.args[:1]:
                        t = dotted(arg)
                        if t in nested:
                            inline.add(t)
                    continue
                if short == "Thread":
                    continue                # targets are roots already
                # anything else receiving a callable is a callback: it
                # runs on whatever thread samples it, even when the
                # defining method only runs at construction time
                for arg in _closure_args(node):
                    cb_entry = set(wrappers.get(short, frozenset()))
                    if isinstance(arg, ast.Lambda):
                        self.units.append(_Unit(
                            f"{name}:<lambda@{arg.lineno}>", arg.body,
                            {"callback"}, cb_entry))
                    elif isinstance(arg, ast.Name) and arg.id in nested:
                        self.units.append(_Unit(
                            f"{name}:{arg.id}", nested[arg.id],
                            {"callback"}, cb_entry))
            for fname in sorted(inline):
                if roots and name != "__init__":
                    self.units.append(_Unit(
                        f"{name}:{fname}", nested[fname], roots, entry))

    def _collect_accesses(self, unit: _Unit) -> None:
        lock_attrs = set(self.cls.locks)
        # Writes lexically before the first Thread(...) construction in
        # a spawning method happen-before every thread it starts
        # (Thread.start() synchronizes-with the run) — initialization,
        # like __init__, not contention.
        spawn_line = None
        # Symmetrically, writes after the method joined its threads
        # (``t.join()`` synchronizes-with thread exit) are *teardown*:
        # they can only race with escaping callbacks, which outlive the
        # joined threads — tracked via the special "teardown" root.
        teardown_line = None
        for node in ast.walk(unit.node):
            if isinstance(node, ast.Call):
                name = dotted(node.func) or ""
                short = name.split(".")[-1]
                if short == "Thread":
                    if spawn_line is None or node.lineno < spawn_line:
                        spawn_line = node.lineno
                elif short == "join":
                    if teardown_line is None or node.lineno > teardown_line:
                        teardown_line = node.lineno

        def record(attr: str, kind: str, line: int,
                   held: frozenset[str]) -> None:
            if attr in lock_attrs:
                return
            if spawn_line is not None and line < spawn_line:
                return
            roots = frozenset(unit.roots)
            if (teardown_line is not None and line > teardown_line
                    and kind == "write"):
                roots = frozenset({"teardown"})
            self.accesses.append(Access(
                attr, kind, roots, held, line,
                f"{self.cls.name}.{unit.name}"))

        def walk(node: ast.AST, held: frozenset[str]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not unit.node:
                return                # separate unit (or local helper)
            if isinstance(node, ast.With):
                extra = set(held)
                for item in node.items:
                    ld = self.reg.resolve(item.context_expr, self.mod,
                                          self.cls)
                    if ld is not None:
                        extra.add(ld.canonical)
                    if item.optional_vars is not None:
                        walk(item.optional_vars, held)
                for sub in node.body:
                    walk(sub, frozenset(extra))
                return
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self":
                kind = "read" if isinstance(node.ctx, ast.Load) else "write"
                record(node.attr, kind, node.lineno, held)
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                tgts = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in tgts:
                    # self.x[i] = v mutates the container behind self.x
                    if isinstance(t, ast.Subscript):
                        base = dotted(t.value) or ""
                        if base.startswith("self.") and \
                                base.count(".") == 1:
                            record(base[len("self."):], "write",
                                   t.lineno, held)
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        walk(unit.node, frozenset(unit.held_entry))


def _guard_findings(analysis: _ClassAnalysis) -> list[Finding]:
    out: list[Finding] = []
    by_attr: dict[str, list[Access]] = {}
    for a in analysis.accesses:
        by_attr.setdefault(a.attr, []).append(a)
    for attr, all_accesses in sorted(by_attr.items()):
        write_roots: set[str] = set()
        all_roots: set[str] = set()
        for a in all_accesses:
            all_roots |= a.roots
            if a.kind == "write":
                write_roots |= a.roots
        live_writes = write_roots - {"teardown"}
        live_shared = (len(live_writes) > 1
                       or bool(live_writes
                               and (all_roots - {"teardown"}) - live_writes))
        if live_shared:
            accesses = all_accesses
        elif "teardown" in write_roots and "callback" in all_roots:
            # teardown writes happen after the worker joins; only the
            # escaping callbacks can still race with them
            accesses = [a for a in all_accesses
                        if "teardown" in a.roots or "callback" in a.roots]
            write_roots = {"teardown"}
        else:
            continue
        common = None
        for a in accesses:
            common = a.held if common is None else common & a.held
        if common:
            continue                    # one lock guards every access
        majority: dict[str, int] = {}
        for a in accesses:
            for lk in a.held:
                majority[lk] = majority.get(lk, 0) + 1
        want = max(majority, key=lambda k: (majority[k], k)) \
            if majority else None
        for a in accesses:
            if want is not None and want in a.held:
                continue
            if want is None and a.held:
                continue
            out.append(Finding(
                "unguarded-attr", analysis.mod.rel, a.line,
                f"{analysis.cls.name}.{attr} is written from roots "
                f"{sorted(write_roots)} but this {a.kind} in {a.detail} "
                f"holds "
                + (f"no lock (expected {want})" if not a.held
                   else f"{sorted(a.held)} (expected {want})")))
    return out


# -- lock-order graph ---------------------------------------------------
def _order_edges(modules: dict[str, Module], reg: _Registry
                 ) -> tuple[dict[str, set[str]],
                            dict[tuple[str, str], tuple[str, int]],
                            list[Finding]]:
    edges: dict[str, set[str]] = {}
    sites: dict[tuple[str, str], tuple[str, int]] = {}
    reacquire: list[Finding] = []
    cls_by_node = {c.node: c for c in reg.classes}

    def walk(node: ast.AST, held: list[LockDef], mod: Module,
             cls: _ClassInfo | None) -> None:
        if isinstance(node, ast.ClassDef):
            sub_cls = cls_by_node.get(node, cls)
            for child in ast.iter_child_nodes(node):
                walk(child, held, mod, sub_cls)
            return
        if isinstance(node, ast.With):
            acquired: list[LockDef] = []
            for item in node.items:
                ld = reg.resolve(item.context_expr, mod, cls)
                if ld is None:
                    continue
                if not ld.reentrant and \
                        any(h.canonical == ld.canonical for h in held):
                    reacquire.append(Finding(
                        "lock-reacquire", mod.rel, item.context_expr.lineno,
                        f"{ld.canonical} acquired while already held "
                        f"(non-reentrant; aliases share the mutex)"))
                elif held:
                    top = held[-1].canonical
                    if top != ld.canonical:
                        edges.setdefault(top, set()).add(ld.canonical)
                        sites.setdefault((top, ld.canonical),
                                         (mod.rel,
                                          item.context_expr.lineno))
                acquired.append(ld)
            for sub in node.body:
                walk(sub, held + acquired, mod, cls)
            return
        for child in ast.iter_child_nodes(node):
            walk(child, held, mod, cls)

    for mod in modules.values():
        walk(mod.tree, [], mod, None)
    return edges, sites, reacquire


def _find_cycles(edges: dict[str, set[str]]) -> list[list[str]]:
    cycles: list[list[str]] = []
    seen_keys: set[tuple[str, ...]] = set()

    def dfs(start: str, node: str, path: list[str]) -> None:
        for nxt in sorted(edges.get(node, ())):
            if nxt == start:
                cyc = path[:]
                key = tuple(sorted(cyc))
                if key not in seen_keys:
                    seen_keys.add(key)
                    cycles.append(cyc)
            elif nxt not in path and len(path) < 6:
                dfs(start, nxt, path + [nxt])

    for start in sorted(edges):
        dfs(start, start, [start])
    return cycles


def run(modules: dict[str, Module]) -> list[Finding]:
    reg = _Registry(modules)
    findings: list[Finding] = []
    for cls in reg.classes:
        analysis = _ClassAnalysis(cls, reg)
        if len(analysis._all_roots()) > 1:
            findings.extend(_guard_findings(analysis))
    edges, sites, reacquire = _order_edges(modules, reg)
    findings.extend(reacquire)
    for cyc in _find_cycles(edges):
        a, b = cyc[0], cyc[1] if len(cyc) > 1 else cyc[0]
        path, line = sites.get((a, b), ("<multiple>", 1))
        findings.append(Finding(
            "lock-order", path, line,
            "lock-order inversion: " + " -> ".join(cyc + [cyc[0]])
            + " (acquisition graph cycle; see docs/static_analysis.md)"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
