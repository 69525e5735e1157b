"""Stage-span tracing: a lock-cheap recorder and a versioned trace export.

`SpanRecorder` collects monotonic-clock spans (name + category plus the
service's natural tags: batch sequence number, layout-bucket key,
worker id) from the admission pump, the four stage workers, the layout
pool, and the fault paths of `repro_torch.serve.design_service` — and from
`repro_torch.api.session`'s stage functions when a recorder is attached to
the session.  The recorder is deliberately dumb: `begin()`/`end()`
each take one short lock to append to a list, the clock is read
*outside* the lock (callers that already read `time.monotonic()` for
their busy clocks pass it in via `at=`, so span edges and occupancy
clocks agree exactly instead of within-jitter), and a recorder that is
simply not attached costs the service one `is None` branch per event.

`TraceExport` is the frozen read side: a schema-stamped snapshot of
every finished span (plus still-open spans flushed at export time —
a mid-batch export must show in-progress stage time, not zero).  It
serializes two ways:

  * `to_dict()`/`to_json()` — a Chrome-trace-compatible event list
    (`traceEvents`, `ph:"X"` complete events and `ph:"i"` instants,
    microsecond timestamps relative to the recorder epoch) that loads
    directly in `chrome://tracing` / Perfetto, under a top-level
    `schema` stamp (`TRACE_SCHEMA`) so CI and future readers can
    detect skew;
  * `gantt()` — the per-batch stage Gantt: batch sequence number ->
    ordered span rows, the replayable visual timeline of one serve run.

`stage_totals()` sums finished+flushed span durations per stage name,
which is what ties the trace back to the service's busy/overlap
clocks: with a single-occupant stage the two are computed from the
very same clock reads and agree to float precision
(`tests/test_torch_telemetry.py`); a K-wide layout pool's busy *clock* is
the refcounted union while the span *sum* counts worker-seconds, so
sum >= clock there by construction.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time

from repro_torch.runtime.lock_sanitizer import make_lock

# Bump on any change to the exported span/event shape.
TRACE_SCHEMA = 1


@dataclasses.dataclass
class Span:
    """One unit of traced work.  `end_s` is None while the span is open;
    timestamps are raw `time.monotonic()` readings (the export
    re-bases them on the recorder epoch)."""

    __slots__ = ("name", "cat", "start_s", "end_s", "batch", "bucket",
                 "worker", "args")

    name: str
    cat: str
    start_s: float
    end_s: float | None
    batch: int | None
    bucket: str | None
    worker: str | None
    args: dict

    @property
    def duration_s(self) -> float:
        return 0.0 if self.end_s is None else self.end_s - self.start_s


class SpanRecorder:
    """Thread-safe, append-only span collector (see module docstring).

    `clock` is injectable for tests; every public entry point accepts
    `at=` so a caller can share one clock read between its own
    accounting and the span edge."""

    def __init__(self, *, clock=time.monotonic):
        self._clock = clock
        self._lock = make_lock("SpanRecorder._lock")
        self.epoch = clock()
        self._spans: list[Span] = []     # finished, in end order
        self._open: dict[int, Span] = {}  # id(span) -> span

    def begin(self, name: str, *, cat: str = "", batch: int | None = None,
              bucket=None, worker: str | None = None,
              at: float | None = None, **args) -> Span:
        span = Span(name=name, cat=cat,
                    start_s=self._clock() if at is None else at,
                    end_s=None, batch=batch,
                    bucket=None if bucket is None else str(bucket),
                    worker=worker, args=args)
        with self._lock:
            self._open[id(span)] = span
        return span

    def end(self, span: Span, *, at: float | None = None) -> Span:
        span.end_s = self._clock() if at is None else at
        with self._lock:
            self._open.pop(id(span), None)
            self._spans.append(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, **tags):
        s = self.begin(name, **tags)
        try:
            yield s
        finally:
            self.end(s)

    def instant(self, name: str, *, cat: str = "", batch: int | None = None,
                bucket=None, worker: str | None = None,
                at: float | None = None, **args) -> Span:
        """A zero-duration event (controller decisions, retries, sheds):
        recorded closed, exported as a Chrome `ph:"i"` instant."""
        t = self._clock() if at is None else at
        span = Span(name=name, cat=cat, start_s=t, end_s=t, batch=batch,
                    bucket=None if bucket is None else str(bucket),
                    worker=worker, args=args)
        with self._lock:
            self._spans.append(span)
        return span

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def export(self, *, flush_open: bool = True) -> "TraceExport":
        """Snapshot every finished span; still-open spans are flushed at
        the current clock (tagged `open=True` in their args) so a
        mid-run export reports in-progress work instead of dropping it.
        The recorder keeps recording — exporting is read-only."""
        now = self._clock()
        with self._lock:
            spans = list(self._spans)
            if flush_open:
                for s in self._open.values():
                    spans.append(Span(name=s.name, cat=s.cat,
                                      start_s=s.start_s, end_s=now,
                                      batch=s.batch, bucket=s.bucket,
                                      worker=s.worker,
                                      args={**s.args, "open": True}))
        spans.sort(key=lambda s: s.start_s)
        return TraceExport(epoch=self.epoch, spans=spans)


@dataclasses.dataclass(frozen=True)
class TraceExport:
    """A frozen, schema-stamped snapshot of one recorder's spans."""

    epoch: float
    spans: list[Span]
    schema: int = TRACE_SCHEMA

    def to_events(self) -> list[dict]:
        """Chrome-trace event list: `ph:"X"` complete events (instants
        as `ph:"i"`), microseconds since the recorder epoch, `tid`
        rows by worker (or category) so Perfetto lays the pipeline out
        as a Gantt without any configuration."""
        events = []
        for s in self.spans:
            args = dict(s.args)
            if s.batch is not None:
                args["batch"] = s.batch
            if s.bucket is not None:
                args["bucket"] = s.bucket
            ev = {"name": s.name, "cat": s.cat or "trace",
                  "ts": (s.start_s - self.epoch) * 1e6,
                  "pid": 0, "tid": s.worker or s.cat or s.name,
                  "args": args}
            if s.end_s is not None and s.end_s > s.start_s:
                ev["ph"] = "X"
                ev["dur"] = (s.end_s - s.start_s) * 1e6
            else:
                ev["ph"] = "i"
                ev["s"] = "g"
            events.append(ev)
        return events

    def to_dict(self) -> dict:
        return {"schema": self.schema,
                "epoch_monotonic_s": self.epoch,
                "displayTimeUnit": "ms",
                "traceEvents": self.to_events()}

    def to_json(self, path=None) -> str:
        """The Chrome-trace JSON text; with `path`, also atomically
        written there (via
        `repro_torch.telemetry.export.atomic_write_json`)."""
        d = self.to_dict()
        if path is not None:
            from repro_torch.telemetry.export import atomic_write_json
            atomic_write_json(d, path)
        return json.dumps(d, indent=1)

    def gantt(self) -> dict:
        """The per-batch stage Gantt: batch seq -> ordered rows of
        `{name, cat, t0_s, t1_s, bucket, worker}` (epoch-relative
        seconds).  Spans with no batch tag (controller decisions, the
        admission pump's idle bookkeeping) land under batch `null` when
        serialized — `-1` here."""
        rows: dict[int, list[dict]] = {}
        for s in self.spans:
            rows.setdefault(-1 if s.batch is None else s.batch, []).append(
                {"name": s.name, "cat": s.cat,
                 "t0_s": s.start_s - self.epoch,
                 "t1_s": None if s.end_s is None else s.end_s - self.epoch,
                 "bucket": s.bucket, "worker": s.worker, "args": s.args})
        for batch in rows.values():
            batch.sort(key=lambda r: r["t0_s"])
        return {"schema": self.schema, "batches": rows}

    def stage_totals(self, cat: str = "stage") -> dict[str, float]:
        """Summed span duration per name within `cat` — the per-stage
        span sums the acceptance check compares with the service's
        busy clocks."""
        totals: dict[str, float] = {}
        for s in self.spans:
            if s.cat == cat:
                totals[s.name] = totals.get(s.name, 0.0) + s.duration_s
        return totals

    @classmethod
    def from_dict(cls, d: dict) -> "TraceExport":
        schema = d.get("schema")
        if schema != TRACE_SCHEMA:
            raise ValueError(f"trace schema {schema} != supported "
                             f"{TRACE_SCHEMA}; re-export the trace")
        epoch = d.get("epoch_monotonic_s", 0.0)
        spans = []
        for ev in d.get("traceEvents", ()):
            t0 = epoch + ev["ts"] / 1e6
            dur = ev.get("dur")
            args = dict(ev.get("args", {}))
            batch = args.pop("batch", None)
            bucket = args.pop("bucket", None)
            tid = ev.get("tid")
            spans.append(Span(
                name=ev["name"], cat=ev.get("cat", ""),
                start_s=t0, end_s=t0 if dur is None else t0 + dur / 1e6,
                batch=batch, bucket=bucket,
                worker=tid if isinstance(tid, str) else None, args=args))
        return cls(epoch=epoch, spans=spans)

    @classmethod
    def from_json(cls, path) -> "TraceExport":
        with open(path) as f:
            return cls.from_dict(json.load(f))
