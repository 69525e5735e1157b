"""Logical activation axes -> mesh axes (MaxText-style logical axis rules).

Counterpart of `repro.parallel.axes`.  Under a `set_rules(mesh, rules)`
context each logical name maps to a mesh axis, a tuple of axes or None,
and `resolve(names)` gives the spec those names take; the port's train
step installs no rules yet (they take effect with tensor parallelism
over "model", ROADMAP item 6.10).  A spec is a plain tuple with one
entry per dimension: an axis name, a tuple of names, or None, entry for
entry the reference's `PartitionSpec`.

`logical(x, *names)` is the identity: the reference's turns into a
`with_sharding_constraint` under the rules, but the port's sharded step
places activations by construction (each mesh position runs the model
on its own rows, `launch.steps.make_train_step`), so there is nothing
to constrain.  The reference's `shard_map` is glue between JAX versions
and has no counterpart here: the port's collectives are copies between
the positions of one process (`parallel.sharding`).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Mapping, Optional

_RULES: contextvars.ContextVar[Optional[tuple[object, Mapping[str, object]]]] = \
    contextvars.ContextVar("logical_axis_rules", default=None)


@contextlib.contextmanager
def set_rules(mesh, rules: Mapping[str, object]):
    """rules: logical name -> mesh axis name | tuple of axis names | None."""
    token = _RULES.set((mesh, dict(rules)))
    try:
        yield
    finally:
        _RULES.reset(token)


def current_rules():
    return _RULES.get()


def _spec_from(rules: Mapping[str, object], names: tuple) -> tuple:
    """Resolve names -> mesh axes, dropping duplicate axis uses (first dim
    keeps the axis; later dims fall back to None)."""
    used: set = set()
    out = []
    for n in names:
        ax = rules.get(n) if isinstance(n, str) else None
        flat = ax if isinstance(ax, tuple) else (ax,) if ax else ()
        if any(a in used for a in flat):
            ax = None
            flat = ()
        used.update(flat)
        out.append(ax)
    return tuple(out)


def resolve(names: tuple) -> Optional[tuple]:
    ctx = _RULES.get()
    if ctx is None:
        return None
    _, rules = ctx
    return _spec_from(rules, names)


def logical(x, *names):
    """The identity (see the module's docstring): activations are placed
    by the step that runs them."""
    return x
