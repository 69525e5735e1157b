"""Kernel-path purity: the port's counterpart of trace purity.

Consumes the `repro_torch.analysis.callgraph` graph, rooted at the
public functions of every kernel family's ``kernel.py`` / ``ops.py``.
Two rules:

  * **host-sync** — in every function a call on the card reaches (CPU
    fences prune, see `callgraph`): ``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``, and
    ``bool()`` / ``int()`` / ``float()`` wrapped directly around a
    tensor-producing call (a ``torch.*`` call, or a reduction method
    such as ``.any()`` / ``.max()`` on a value not known to be a numpy
    array).  Each stalls the host until the card drains its queue, so
    the launch that follows cannot overlap the work before it.  A sync
    the path needs (the read of a bucket's extents that sizes
    ``route_slots``' launch) carries a suppression with its reason;
    `docs/torch_static_analysis.md` lists them.
  * **host-guard** — the port's no-fallback contract: in a family's
    ``kernel.py`` / ``ops.py``, every call into a ``ref`` module (the
    plain PyTorch version) sits behind a CPU-device fence, and no
    ``except`` handler calls into one, so a CUDA tensor launches the
    kernel or raises and never runs the plain version unasked.

The JAX package's ``host-call``, ``inplace-store`` and
``set-iteration`` guard a jit tracer; under eager PyTorch they mean
nothing (`repro_torch.analysis.core.INERT_RULES` gives each reason).
The graph stops at ``ref`` modules: an edge into one is host-guard's.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.callgraph import CallGraph, FuncInfo, is_root_module
from repro_torch.analysis.core import Finding, Module, dotted

_REF_MODULE_RE = re.compile(r"repro_torch\.kernels\.\w+\.ref$")
# Methods that copy a tensor to the host (a sync on a CUDA tensor).
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_SYNC_CALLS = {"torch.cuda.synchronize"}
# Tensor methods whose result, wrapped in bool() / int() / float(), is
# read back to the host.
_TENSOR_REDUCTIONS = {"any", "all", "sum", "max", "min", "amax", "amin",
                      "argmax", "argmin", "mean", "prod", "count_nonzero",
                      "norm", "std", "var"}
_NUMPY_PREFIXES = ("np.", "numpy.")


def _short(fid: str) -> str:
    mod, _, qual = fid.partition(":")
    return f"{mod.rsplit('.', 1)[-1]}.{qual}"


def _is_ref_fid(fid: str | None) -> bool:
    return fid is not None and \
        _REF_MODULE_RE.fullmatch(fid.partition(":")[0]) is not None


class _NumpyNames:
    """Names a function binds to numpy values (assigned from ``np.*``,
    ``.numpy()``, or arithmetic over such names), in statement order: a
    reduction on one of them is host arithmetic, not a sync."""

    def __init__(self, fn: ast.AST):
        self.names: set[str] = set()
        assigns = sorted((n for n in ast.walk(fn)
                          if isinstance(n, ast.Assign)),
                         key=lambda n: (n.lineno, n.col_offset))
        for node in assigns:
            numpy = self.is_numpy(node.value)
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    (self.names.add if numpy
                     else self.names.discard)(tgt.id)

    def is_numpy(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Call):
            name = dotted(e.func) or ""
            if name.startswith(_NUMPY_PREFIXES):
                return True
            if isinstance(e.func, ast.Attribute):
                return e.func.attr == "numpy" or self.is_numpy(e.func.value)
            return False
        if isinstance(e, ast.BinOp):
            return self.is_numpy(e.left) or self.is_numpy(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_numpy(e.operand)
        if isinstance(e, ast.Compare):
            return self.is_numpy(e.left) or any(
                self.is_numpy(c) for c in e.comparators)
        if isinstance(e, (ast.Subscript, ast.Attribute)):
            return self.is_numpy(e.value)
        return False


def _tensor_producing(call: ast.expr, numpy: _NumpyNames) -> str | None:
    """The tensor-producing call ``call`` is, or combines with operators
    (``(a < 0).any() | (b < 0).any()``), else None."""
    if isinstance(call, (ast.BinOp, ast.BoolOp, ast.UnaryOp, ast.Compare)):
        parts = {ast.BinOp: lambda e: (e.left, e.right),
                 ast.BoolOp: lambda e: e.values,
                 ast.UnaryOp: lambda e: (e.operand,),
                 ast.Compare: lambda e: (e.left, *e.comparators)}
        for sub in parts[type(call)](call):
            hit = _tensor_producing(sub, numpy)
            if hit is not None:
                return hit
        return None
    if not isinstance(call, ast.Call):
        return None
    name = dotted(call.func) or ""
    if name.startswith("torch."):
        return name
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in _TENSOR_REDUCTIONS and \
            not numpy.is_numpy(call.func.value):
        return f".{call.func.attr}"
    return None


def _sync_findings(info: FuncInfo, why: str) -> list[Finding]:
    out: list[Finding] = []
    numpy = _NumpyNames(info.node)
    for site in info.calls:
        if site.plain_only:
            continue
        call, func = site.node, site.node.func
        hit = None
        if (site.norm or "") in _SYNC_CALLS:
            hit = f"{site.norm}()"
        elif isinstance(func, ast.Attribute) and site.fid is None and \
                func.attr in _SYNC_METHODS and not call.args and \
                not numpy.is_numpy(func.value):
            inner = func.value
            # x.cpu().numpy() is one copy: reported once, at .cpu()
            if not (isinstance(inner, ast.Call)
                    and isinstance(inner.func, ast.Attribute)
                    and inner.func.attr == "cpu"):
                hit = f".{func.attr}()"
        elif (site.norm or "") in ("bool", "int", "float") and call.args:
            inner = _tensor_producing(call.args[0], numpy)
            if inner is not None:
                hit = f"{site.norm}({inner}(...))"
        if hit is not None:
            out.append(Finding(
                "host-sync", info.module.rel, call.lineno,
                f"{hit} in {_short(info.fid)} syncs the host with the card "
                f"on the device path ({why})"))
    return out


def _host_guard_findings(graph: CallGraph, mod: Module) -> list[Finding]:
    """The no-fallback contract in `repro_torch.kernels.*.{kernel,ops}`."""
    out: list[Finding] = []
    if not is_root_module(mod.name):
        return out
    for info in graph.functions.values():
        if info.module is not mod:
            continue
        for site in info.calls:
            target = site.fid or ""
            if not _is_ref_fid(target):
                owner = (site.norm or "").rpartition(".")[0]
                if not _REF_MODULE_RE.fullmatch(owner):
                    continue
            callee = dotted(site.node.func) or target
            if site.in_except:
                out.append(Finding(
                    "host-guard", mod.rel, site.node.lineno,
                    f"plain version {callee}() called from an except "
                    f"handler in {_short(info.fid)}: a failed launch must "
                    f"raise, not fall back"))
            elif not site.plain_only:
                out.append(Finding(
                    "host-guard", mod.rel, site.node.lineno,
                    f"plain version {callee}() in {_short(info.fid)} is not "
                    f"behind a CPU-device fence (`if x.device.type == "
                    f"\"cpu\":`); a CUDA tensor must launch the kernel or "
                    f"raise"))
    return out


def run(modules: dict[str, Module],
        graph: CallGraph | None = None) -> list[Finding]:
    graph = graph or CallGraph(modules)
    findings: list[Finding] = []
    for fid, why in sorted(graph.device_reachable(stop=_is_ref_fid).items()):
        findings.extend(_sync_findings(graph.functions[fid], why))
    for mod in modules.values():
        findings.extend(_host_guard_findings(graph, mod))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
