"""Telemetry & adaptive control plane for the design service.

Three layers, each usable alone:

  * tracing (`repro_torch.telemetry.spans`) — `SpanRecorder` collects
    monotonic-clock stage spans; `TraceExport` serializes them as a
    schema-stamped, Chrome-trace-compatible event list and a per-batch
    stage Gantt;
  * metrics (`repro_torch.telemetry.metrics` +
    `repro_torch.telemetry.export`) — a typed
    `Counter`/`Gauge`/`Histogram` registry snapshotable as versioned
    JSON or prometheus text;
  * control (`repro_torch.telemetry.control`) — `FeedbackController` turns
    windowed metrics (arrival-rate EMA, queue depth, pool occupancy)
    into adaptive-coalescing and pool-autoscaling decisions, each
    recorded as a span.

`Telemetry` is the bundle `repro_torch.serve.design_service.DesignService`
accepts (`telemetry=Telemetry()` or `telemetry=True`): one recorder +
one registry wired through the admission pump, all four stage workers,
the layout pool, and the retry/shed/preemption paths.

Counterpart of the JAX package's `telemetry` package, copied so the
port imports nothing of it.  Schema stamps and metric names are the
reference's, so a scrape of either package reads the same.
"""
from repro_torch.telemetry.control import (ControlDecision,
                                           ControllerConfig,
                                           FeedbackController)
from repro_torch.telemetry.export import (atomic_write_json, load_snapshot,
                                          render_prometheus,
                                          write_metrics_json)
from repro_torch.telemetry.metrics import (DEFAULT_LATENCY_BUCKETS,
                                           HISTOGRAM_SAMPLE_CAP,
                                           METRICS_SCHEMA, Counter, Gauge,
                                           Histogram, MetricsRegistry,
                                           percentile)
from repro_torch.telemetry.spans import (TRACE_SCHEMA, Span, SpanRecorder,
                                         TraceExport)


class Telemetry:
    """One recorder + one registry: what the service threads through its
    pump, stages, pool, and fault paths.  Pass your own pieces to share
    a recorder between a session and several services, or rely on the
    defaults."""

    def __init__(self, *, recorder: SpanRecorder | None = None,
                 metrics: MetricsRegistry | None = None):
        self.recorder = recorder if recorder is not None else SpanRecorder()
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    def export(self) -> TraceExport:
        return self.recorder.export()


__all__ = [
    "ControlDecision", "ControllerConfig", "Counter",
    "DEFAULT_LATENCY_BUCKETS", "FeedbackController", "Gauge", "Histogram",
    "HISTOGRAM_SAMPLE_CAP", "METRICS_SCHEMA", "MetricsRegistry", "Span",
    "SpanRecorder", "TRACE_SCHEMA", "Telemetry", "TraceExport",
    "atomic_write_json", "load_snapshot", "percentile", "render_prometheus",
    "write_metrics_json",
]
