"""Typed service metrics: counters, gauges, histograms, one registry.

This absorbs the ad-hoc `collections.Counter` accounting that
`DesignService.stats()` keeps into a typed, snapshotable
registry.  Three metric kinds:

  * `Counter` — monotonically increasing totals (dispatches, retries,
    cache hits).  Backed either by its own atomic int or by a `fn`
    callback sampled at snapshot time — the service proxies its
    existing `session.stats` keys through callbacks so there is ONE
    source of truth and `stats()` stays a thin compatibility view
    instead of a second bookkeeping system;
  * `Gauge` — point-in-time levels (queue depth, stage occupancy,
    live worker count), also callback-backed for the same reason;
  * `Histogram` — fixed log-spaced buckets (`DEFAULT_LATENCY_BUCKETS`:
    powers of two from 1 ms to ~73 min) plus a bounded reservoir of
    raw samples, so `summary()` reports exact p50/p95/p99 through the
    *same* `percentile()` every report uses (identical quantile math
    by construction, not by convention) while the bucket counts stay
    prometheus-renderable.

Metrics are identified by name + optional label set (e.g.
`tickets_served_total{tier="artifact_cache"}`); asking the registry
for the same (name, labels) twice returns the same object.
`MetricsRegistry.snapshot()` is the versioned JSON form
(`METRICS_SCHEMA`); `repro_torch.telemetry.export.render_prometheus` turns a
snapshot into prometheus text exposition format.

`percentile()` reimplements numpy's default linear-interpolation
quantile in pure Python, so every ticket p50/p99 the package reports
comes from one helper and histogram summaries can never disagree on
quantile math.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time

from repro_torch.runtime.lock_sanitizer import make_lock

# Bump on any change to the snapshot shape.
METRICS_SCHEMA = 1

# Log-spaced (powers of two) latency bucket upper bounds, seconds:
# 1 ms .. ~4369 s.  Fixed so histograms from different processes /
# bench runs are mergeable bucket-for-bucket.
DEFAULT_LATENCY_BUCKETS = tuple(0.001 * 2.0 ** i for i in range(23))

# Bounded sample reservoir per histogram: enough to keep service-bench
# scale exact (hundreds of tickets) without letting a long-lived fleet
# grow memory without bound.  Beyond the cap the reservoir keeps the
# most recent samples (sliding window), which is the right bias for an
# operator asking "what is latency like *now*".
HISTOGRAM_SAMPLE_CAP = 8192


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of `values` with linear
    interpolation between closest ranks — bit-identical to
    `numpy.percentile(values, q)` at default settings for finite
    inputs.  Raises on an empty sequence, same as numpy."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile() of an empty sequence")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q!r} outside [0, 100]")
    rank = (q / 100.0) * (len(xs) - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return xs[int(rank)]
    return xs[lo] * (hi - rank) + xs[hi] * (rank - lo)


def _label_key(labels: dict | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


@dataclasses.dataclass
class Counter:
    """Monotonic total; `fn` (if set) is sampled at snapshot time and
    wins over the internal count — proxy mode for pre-existing stats."""

    name: str
    help: str = ""
    labels: dict = dataclasses.field(default_factory=dict)
    fn: object = None
    _value: float = 0.0
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                              repr=False)

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("Counter.inc() must be non-negative")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        if self.fn is not None:
            return float(self.fn())
        with self._lock:
            return self._value

    def to_dict(self) -> dict:
        return {"type": "counter", "help": self.help,
                "labels": dict(self.labels), "value": self.value}


@dataclasses.dataclass
class Gauge:
    """Point-in-time level; callback-backed (`fn`) or `set()`-driven."""

    name: str
    help: str = ""
    labels: dict = dataclasses.field(default_factory=dict)
    fn: object = None
    _value: float = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return float(self.fn()) if self.fn is not None else self._value

    def to_dict(self) -> dict:
        return {"type": "gauge", "help": self.help,
                "labels": dict(self.labels), "value": self.value}


class Histogram:
    """Fixed-bucket histogram with a bounded exact-sample reservoir.

    `buckets` are the inclusive upper bounds (`le`), ascending; an
    implicit +inf bucket catches the tail.  Thread-safe: layout pool
    workers and the admission pump observe concurrently."""

    def __init__(self, name: str, help: str = "", *,  # noqa: A002
                 labels: dict | None = None,
                 buckets=DEFAULT_LATENCY_BUCKETS,
                 sample_cap: int = HISTOGRAM_SAMPLE_CAP):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("histogram buckets must be ascending and "
                             "non-empty")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # + the +inf tail
        self._sum = 0.0
        self._count = 0
        self._samples: collections.deque = collections.deque(
            maxlen=sample_cap)
        self._lock = make_lock("Histogram._lock")

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        while i < len(self.bounds) and v > self.bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._samples.append(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def summary(self) -> dict:
        """count/sum/min/max plus exact p50/p95/p99 over the retained
        reservoir — the module's one `percentile()`."""
        with self._lock:
            xs = list(self._samples)
            count, total = self._count, self._sum
        out = {"count": count, "sum": total}
        if xs:
            out.update(min=min(xs), max=max(xs),
                       p50=percentile(xs, 50), p95=percentile(xs, 95),
                       p99=percentile(xs, 99))
        return out

    def to_dict(self) -> dict:
        with self._lock:
            counts = list(self._counts)
        return {"type": "histogram", "help": self.help,
                "labels": dict(self.labels),
                "buckets": [[b, c] for b, c in zip(self.bounds, counts)],
                "inf_count": counts[-1],
                "count": self._count, "sum": self._sum,
                "summary": self.summary()}


class MetricsRegistry:
    """Name + label keyed store of the three metric kinds.

    Re-registering the same (name, labels) returns the existing
    object (callbacks may be refreshed); registering the same name as
    a *different* kind raises — a scrape endpoint with one name
    meaning two things is a lying endpoint."""

    def __init__(self):
        self._lock = make_lock("MetricsRegistry._lock")
        self._metrics: dict[tuple, object] = {}

    def _register(self, cls, name, help_, labels, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, not {cls.__name__}")
                fn = kw.get("fn")
                if fn is not None and hasattr(existing, "fn"):
                    existing.fn = fn
                return existing
            metric = cls(name, help_, labels=dict(labels or {}), **kw)
            self._metrics[key] = metric
            return metric

    def counter(self, name: str, help_: str = "", *,
                labels: dict | None = None, fn=None) -> Counter:
        return self._register(Counter, name, help_, labels, fn=fn)

    def gauge(self, name: str, help_: str = "", *,
              labels: dict | None = None, fn=None) -> Gauge:
        return self._register(Gauge, name, help_, labels, fn=fn)

    def histogram(self, name: str, help_: str = "", *,
                  labels: dict | None = None,
                  buckets=DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help_, labels,
                              buckets=buckets)

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    def snapshot(self) -> dict:
        """The versioned, JSON-serializable scrape: every metric's
        `to_dict()` (callbacks sampled NOW), grouped as a list per name
        so label families stay together."""
        with self._lock:
            metrics = list(self._metrics.values())
        series: dict[str, list] = {}
        for m in metrics:
            series.setdefault(m.name, []).append(m.to_dict())
        return {"schema": METRICS_SCHEMA,
                "time_unix_s": time.time(),
                "metrics": series}
