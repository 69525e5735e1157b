"""Runtime lock-order sanitizer of the port's threaded code.

Counterpart of the JAX package's `runtime/lock_sanitizer.py`, copied so
the port imports nothing of it.

Env-gated (``REPRO_LOCK_SANITIZER=1``): the threaded code paths create
their locks through :func:`make_lock` / :func:`make_condition`, which
return plain ``threading`` primitives when the gate is off (zero
overhead) and named :class:`InstrumentedLock` wrappers when it is on.
Instrumented locks record, per thread, the stack of locks held at every
acquisition; each acquisition while another lock is held contributes an
edge ``held -> acquired`` to a global acquisition-order graph.

Any time via :func:`assert_clean` (on :data:`GLOBAL_REGISTRY`), a
cycle in that graph is reported as an AssertionError naming the
inversion.  The dynamic view sees acquisition orders through callbacks,
``Condition.wait`` reacquisitions, and data-dependent paths.

Re-acquiring a non-reentrant instrumented lock on the same thread is
reported *immediately* (it would deadlock for real), with both
acquisition sites named.
"""
from __future__ import annotations

import os
import threading

ENV_FLAG = "REPRO_LOCK_SANITIZER"


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "").strip().lower() not in (
        "", "0", "false", "no")


class LockOrderRegistry:
    """Global acquisition-order graph over named locks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()          # raw: guards the graph itself
        self._edges: dict[tuple[str, str], int] = {}
        self._held = threading.local()

    # -- per-thread held stack ----------------------------------------
    def _stack(self) -> list[str]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def check_deadlock(self, name: str) -> None:
        """Raise if the current thread already holds ``name``.  Must run
        *before* blocking on the underlying lock — a same-thread
        re-acquisition would otherwise deadlock for real instead of
        reporting."""
        stack = self._stack()
        if name in stack:
            raise AssertionError(
                f"lock sanitizer: {name} acquired while already held on "
                f"{threading.current_thread().name} (held: {stack}) — "
                f"guaranteed deadlock")

    def note_acquire(self, name: str, *, reentrant: bool = False) -> None:
        stack = self._stack()
        if not reentrant:
            self.check_deadlock(name)
        if stack:
            edge = (stack[-1], name)
            if edge[0] != edge[1]:
                with self._mu:
                    self._edges[edge] = self._edges.get(edge, 0) + 1
        stack.append(name)

    def note_release(self, name: str) -> None:
        stack = self._stack()
        if name in stack:
            # remove the innermost occurrence: releases may be
            # out-of-order under Condition.wait bookkeeping
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == name:
                    del stack[i]
                    break

    # -- verdicts ------------------------------------------------------
    def edges(self) -> dict[tuple[str, str], int]:
        with self._mu:
            return dict(self._edges)

    def find_cycle(self) -> list[str] | None:
        edges = self.edges()
        adj: dict[str, set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)

        def dfs(start: str, node: str, path: list[str]) -> list[str] | None:
            for nxt in sorted(adj.get(node, ())):
                if nxt == start:
                    return path
                if nxt not in path and len(path) < 8:
                    hit = dfs(start, nxt, path + [nxt])
                    if hit is not None:
                        return hit
            return None

        for start in sorted(adj):
            cyc = dfs(start, start, [start])
            if cyc is not None:
                return cyc
        return None

    def assert_clean(self) -> None:
        cyc = self.find_cycle()
        if cyc is not None:
            counts = self.edges()
            detail = ", ".join(
                f"{a}->{b} (x{counts.get((a, b), 0)})"
                for a, b in zip(cyc, cyc[1:] + cyc[:1]))
            raise AssertionError(
                "lock sanitizer: acquisition-order inversion observed: "
                + " -> ".join(cyc + [cyc[0]]) + f" [{detail}]")

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()


#: process-wide registry the instrumented locks report into
GLOBAL_REGISTRY = LockOrderRegistry()


class InstrumentedLock:
    """A named ``threading.Lock`` that reports acquisition order.

    Duck-types a plain lock (``acquire`` / ``release`` / context
    manager / ``locked``), so ``threading.Condition`` can wrap it: the
    Condition's own ``wait()`` release/reacquire cycles route through
    these methods and are order-checked like any other acquisition.
    """

    def __init__(self, name: str,
                 registry: LockOrderRegistry | None = None) -> None:
        self.name = name
        self._registry = registry or GLOBAL_REGISTRY
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Pre-check before blocking: a same-thread re-acquisition must
        # raise, not sit on the inner lock forever.  Non-blocking probes
        # are exempt — they cannot deadlock, and Condition._is_owned
        # legitimately tries acquire(False) on a lock it already holds.
        if blocking:
            self._registry.check_deadlock(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._registry.note_acquire(self.name)
        return got

    def release(self) -> None:
        self._registry.note_release(self.name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self.name} {self._inner!r}>"


def make_lock(name: str):
    """A lock for a threaded subsystem: instrumented under the
    sanitizer gate, a plain ``threading.Lock`` otherwise."""
    if enabled():
        return InstrumentedLock(name)
    return threading.Lock()


def make_condition(lock):
    """A ``threading.Condition`` over a :func:`make_lock` result (plain
    or instrumented — Condition only needs acquire/release)."""
    return threading.Condition(lock)
