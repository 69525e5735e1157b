"""Render and persist telemetry snapshots: prometheus text + atomic JSON.

The scrape surface of the telemetry subsystem is file/string-shaped on
purpose: the service stays a library (no HTTP dependency baked in),
and anything that can serve a string — a debug handler, a cron job
writing a node-exporter textfile, a control CLI — becomes a
metrics endpoint.  Two formats from one `MetricsRegistry.snapshot()`:

  * `render_prometheus(snapshot)` — text exposition format
    (`# HELP`/`# TYPE` headers, `_bucket{le=...}` cumulative histogram
    series with the canonical `+Inf` bound, `_sum`/`_count`);
  * `atomic_write_json(payload, path)` — temp-file + `os.replace`, the
    same durability contract as `DesignArtifact.to_json` (readers only
    ever see a complete file), shared by metrics snapshots and
    `TraceExport` dumps.

`load_snapshot(path)` is the read side for the CLI: it validates the
`schema` stamp against `METRICS_SCHEMA` so an operator inspecting a
stale dump gets a clear error instead of nonsense columns.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

from repro_torch.telemetry.metrics import METRICS_SCHEMA

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_VAL_ESCAPES = {"\\": r"\\", "\n": r"\n", '"': r'\"'}


def _name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _labels(labels: dict, extra: dict | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    parts = []
    for k, v in sorted(merged.items()):
        v = "".join(_LABEL_VAL_ESCAPES.get(ch, ch) for ch in str(v))
        parts.append(f'{_name(str(k))}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def render_prometheus(snapshot: dict) -> str:
    """Prometheus text exposition of a `MetricsRegistry.snapshot()`."""
    schema = snapshot.get("schema")
    if schema != METRICS_SCHEMA:
        raise ValueError(f"metrics schema {schema} != supported "
                         f"{METRICS_SCHEMA}; re-snapshot the registry")
    lines = []
    for name, series in snapshot["metrics"].items():
        pname = _name(name)
        kind = series[0]["type"]
        help_ = next((s["help"] for s in series if s.get("help")), "")
        if help_:
            lines.append(f"# HELP {pname} {help_}")
        lines.append(f"# TYPE {pname} {kind}")
        for s in series:
            labels = s.get("labels", {})
            if kind in ("counter", "gauge"):
                lines.append(f"{pname}{_labels(labels)} {_fmt(s['value'])}")
                continue
            acc = 0
            for le, count in s["buckets"]:
                acc += count
                lines.append(f"{pname}_bucket"
                             f"{_labels(labels, {'le': _fmt(le)})} {acc}")
            acc += s.get("inf_count", 0)
            lines.append(f"{pname}_bucket"
                         f"{_labels(labels, {'le': '+Inf'})} {acc}")
            lines.append(f"{pname}_sum{_labels(labels)} {_fmt(s['sum'])}")
            lines.append(f"{pname}_count{_labels(labels)} {s['count']}")
    return "\n".join(lines) + "\n"


def atomic_write_json(payload: dict, path) -> None:
    """Temp-file + `os.replace` JSON write in the target's directory, so
    a crash mid-dump can never leave a truncated snapshot behind."""
    path = os.fspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_metrics_json(snapshot: dict, path) -> None:
    """Persist a metrics snapshot (schema-checked on the way out, so a
    bad dump fails at write time, not at the operator's read)."""
    if snapshot.get("schema") != METRICS_SCHEMA:
        raise ValueError("refusing to write a snapshot without the "
                         "current METRICS_SCHEMA stamp")
    atomic_write_json(snapshot, path)


def load_snapshot(path) -> dict:
    """Read + schema-validate a metrics snapshot dumped by
    `write_metrics_json` (the CLI's inspect path)."""
    with open(path) as f:
        d = json.load(f)
    schema = d.get("schema") if isinstance(d, dict) else None
    if schema != METRICS_SCHEMA:
        raise ValueError(f"metrics snapshot at {path} has schema "
                         f"{schema}, supported {METRICS_SCHEMA}")
    return d
