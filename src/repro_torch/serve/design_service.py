"""Multi-tenant design service: a staged-pipeline, deadline-coalescing,
fault-tolerant front door over the port's `DesignSession`.

Counterpart of the JAX package's `serve/design_service.py`.
`DesignService(mesh=...)` forwards to the session's device-mesh explore
engine as the reference's does; `device=` picks the device of the
session made here.  Concurrent users `submit()` `DesignRequest`s and collect
ticketed `DesignArtifact`s, while the service amortizes the heavy work
across tenants.  Two driving modes share one queue:

  * **synchronous drain** — `step()` takes one coalesced batch (up to
    `max_coalesce` requests), `run()` drains everything: the right tool
    for scripted batch jobs.
  * **staged pipeline** — `serve()` starts an admission pump with
    latency-bounded coalescing windows (dispatch at `max_coalesce`
    queued OR `coalesce_window_s` past the oldest request) feeding the
    stage workers over queues:

        admission ─> explore ─> distill ─> layout pool ─> finalize
                      (batch)    (batch)   (K x bucket)    (batch)

    Each stage runs the *same* `DesignSession` stage function the
    sequential `run_many` driver uses (`explore_stage`,
    `distill_stage`, `layout_stage`, `finalize_stage` — see
    `repro_torch.api.session`), so pipelined and sequential execution
    cannot diverge: artifacts are ticket-for-ticket equal (asserted in
    `tests/test_torch_design_service.py`).  What the pipeline buys is
    **overlap**: batch N+1's exploration runs while batch N's layout
    buckets are still in flight, and layout buckets *stream* — the
    distill worker submits each bucket the moment it is formed, and
    `layout_workers=K` pool workers consume the bucket queue
    concurrently.  `serve(pipelined=False)` is the serial pump (one
    thread, one coalesced batch at a time through `run_many`), kept for
    comparison.

On the card: every stage thread and pool worker launches on the one
legacy default CUDA stream (no worker gets a stream of its own).  The
kernel wrappers allocate per-call scratch that PyTorch's caching
allocator hands from thread to thread, which is safe only on one
stream.  So the explore worker's `nsga2_evolve` and the pool's
`route_slots` launches interleave on one queue; what overlaps is the
host work of the stages around them.

Stage-safety: the `DesignSession` is not thread-safe in general, but
the stages partition its state — only the explore worker touches the
program/front caches, only the distill worker forms buckets, only the
finalize worker writes the artifact cache — and the one stage that
*does* fan out, layout, calls only `session.layout_stage`, which is
pure compute plus a locked counter.  Every `stats` counter mutation —
session stages and service threads alike — goes through
`session.bump()` under `session.stats_lock`, and snapshots copy under
the same lock (`repro_torch.runtime.lock_sanitizer` checks acquisition
order at runtime).  `run()`/`step()` are refused while a pump is
active so no second dispatcher can break that partition.

Failure semantics:

  * **Per-bucket isolation** — a layout bucket that raises is retried
    with capped exponential backoff + jitter
    (`repro_torch.runtime.fault_tolerance.capped_backoff`; knobs
    `max_retries` / `retry_backoff_s` / `retry_backoff_cap_s` /
    `retry_jitter`).  A bucket that exhausts the budget is recorded on
    its batch, and at finalize only the tickets *touching* that bucket
    complete with `artifact.error` — batch-mates whose specs landed in
    healthy buckets get full artifacts.
  * **Per-batch isolation** — an explore / distill / finalize failure
    is retried on the same budget, then the batch's tickets complete
    with `session.error_artifact` (`served_from="error"`) instead of
    poisoning the pipeline.  Requests whose requirements remove every
    Pareto point were already non-poisoning (non-strict distill).
  * **Supervised workers** — each stage worker thread runs under
    `repro_torch.runtime.fault_tolerance.run_supervised`
    (`worker_restarts` budget, backoff between restarts): a crash in
    the worker loop *itself* re-queues the in-hand unit and restarts
    the loop in process.  Only an exhausted restart budget stops the
    pipeline (first failure wins): it is surfaced to blocked
    `collect()` callers and re-raised from `close()`, and every
    in-flight batch is restored — in admission order, at the FRONT of
    the queue — so no ticket is lost or reordered.
  * **Preemption** — with a `PreemptionGuard` attached (`guard=...`),
    SIGTERM (or `guard.request()`, or a `FailureInjector` of kind
    `preempt`) makes the pump stop admitting, journal every unfinished
    ticket's `DesignRequest` to the WAL beside the artifact cache
    (`repro_torch.api.artifact_cache.TicketJournal`, admission order
    preserved), and drain the already-admitted batches to completion.
    A *fresh* service over the same cache root replays the journal on
    `serve()` (or explicit `replay_journal()`): the requests are
    resubmitted in order and their artifacts re-stamped
    `served_from="journal_replay"` — drained work that reached the
    artifact cache before the old process died is served from disk, so
    replay converges instead of recomputing the world.
  * **Straggler shedding** — with a `StragglerMonitor` attached
    (`straggler=...`) and `layout_workers > 1`, a watchdog thread polls
    the pool's in-flight buckets; one stuck past `threshold x EMA`
    (`StragglerMonitor.stuck`) is re-queued to a peer worker.  First
    completion wins; the loser is cancelled-on-observe (its result is
    dropped when it finally returns — `shed_losses` in stats).

    Every path above is deterministically testable without real
    signals or flaky sleeps via `FailureInjector` (`injector=...`)
    with a stage/unit-keyed schedule: `fail_at={"layout": [2]}` kills
    the third layout bucket dispatch, kinds `node|slow|preempt`
    (`tests/test_torch_service_faults.py`).

Accounting: `service.stats()` returns a point-in-time **snapshot** —
session + service counters (`explorer_dispatches`,
`layout_dispatches`, `run_cell_traces`, cache hits/misses, the
`service_batches` / `service_batch_requests` pair whose ratio is the
realized coalescing factor, and the fault-tolerance counters
`bucket_retries` / `bucket_failures` / `shed_buckets` / `shed_losses`
/ `stage_worker_restarts` / `preemptions` / `journaled_tickets`) plus
live pipeline gauges (queue depths, per-stage occupancy and cumulative
busy time, and the explore/layout overlap clock the overlap fraction
is computed from).

Telemetry & control: `stats()` is the thin compatibility view over a
typed metrics registry — `service.metrics()` returns the versioned,
scrape-able snapshot (`repro_torch.telemetry.metrics.MetricsRegistry`:
stats-proxied counters, live gauges with open busy clocks flushed,
ticket end-to-end latency and per-bucket layout-seconds histograms,
`served_from` tier and fault-family counters), renderable as prometheus
text via `repro_torch.telemetry.export.render_prometheus`.  Metric
names are the reference's (`design_mesh_dispatches_total` counts the
session's explore dispatches on the device mesh).  With
`telemetry=Telemetry()` (or `True`), a `SpanRecorder` traces the
admission pump, every stage-worker unit (the span edges share the
exact clock reads of the busy clocks), the layout pool, and each
retry/shed/preemption/replay event — `service.trace()` exports the
whole run as a Chrome-trace-compatible, schema-stamped event list and
a per-batch stage Gantt.  With `controller=FeedbackController(...)`
(or a `ControllerConfig`), the pump additionally runs a feedback tick
each admission iteration: the arrival-rate EMA eases
`coalesce_window_s` between the configured bounds, and sustained
layout backlog / idleness grows or shrinks the layout pool between
`min_workers`/`max_workers` with hysteresis — every actuation is
itself a `cat="control"` span.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import random
import threading
import time

from repro_torch.api.artifact_cache import TicketJournal
from repro_torch.api.request import DesignRequest
from repro_torch.api.session import DesignArtifact, DesignSession
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 PreemptionGuard,
                                                 StragglerMonitor,
                                                 capped_backoff,
                                                 run_supervised)
from repro_torch.runtime.lock_sanitizer import make_condition, make_lock
from repro_torch.telemetry import (ControllerConfig, FeedbackController,
                                   MetricsRegistry, Telemetry, TraceExport)

_STAGES = ("explore", "distill", "layout", "finalize")

# Layout-queue token telling exactly one pool worker to retire (the
# controller's scale-down path).  Consuming it runs the SAME live-count
# bookkeeping as the close sentinel, so a shrink racing close() still
# fires the finalize sentinel exactly once.
_SHRINK = object()


class UnknownTicket(KeyError):
    """Raised for a ticket this service never issued, or whose artifact
    was already collected (and popped — pass `keep_done=True` to keep)."""

    def __str__(self) -> str:  # KeyError repr-quotes its message otherwise
        return self.args[0] if self.args else ""


class PendingTicket(RuntimeError):
    """Raised when a ticket's artifact is not ready: the request is still
    queued or in flight.  Distinct from `UnknownTicket` so callers can
    tell "wait longer / drain the queue" from "you never submitted this"."""


class _Batch:
    """One coalesced batch moving through the staged pipeline.

    The fault-isolation state rides on the batch: `failed` maps a
    layout bucket key to its terminal `(message, attempts)` after the
    retry budget, `completed`/`shed` implement first-completion-wins
    for shed buckets, and `error` is the batch-level terminal message
    (explore/distill/finalize exhausted their retries) that turns every
    ticket into an `error_artifact`.  All mutated under the service
    lock once the layout pool can see the batch."""

    __slots__ = ("entries", "seq", "admitted_at", "explored", "distilled",
                 "results", "remaining", "waits", "failed", "completed",
                 "shed", "error")

    def __init__(self, entries, seq: int = -1):
        self.entries = entries          # [(ticket, request, t_submit)]
        self.seq = seq                  # admission sequence (span tag)
        self.admitted_at = time.monotonic()
        self.explored = None            # ExploredBatch after explore
        self.distilled = None           # DistilledBatch after distill
        self.results = []               # [BucketResult]
        self.remaining = 0              # buckets not yet settled
        self.waits = {}                 # request -> explore queue wait (s)
        self.failed = {}                # bucket key -> (message, attempts)
        self.completed = set()          # bucket keys with a winning result
        self.shed = set()               # bucket keys re-queued by watchdog
        self.error = None               # batch-level terminal message


class DesignService:
    """Queue-backed multi-tenant layer over a `DesignSession`."""

    def __init__(self, session: DesignSession | None = None, *,
                 max_coalesce: int = 16, coalesce_window_s: float = 0.05,
                 pipeline_depth: int = 2, layout_workers: int = 1,
                 max_retries: int = 2, retry_backoff_s: float = 0.05,
                 retry_backoff_cap_s: float = 2.0,
                 retry_jitter: float = 0.1, worker_restarts: int = 2,
                 straggler: StragglerMonitor | None = None,
                 guard: PreemptionGuard | None = None,
                 journal: TicketJournal | str | None = None,
                 injector: FailureInjector | None = None,
                 telemetry: Telemetry | bool | None = None,
                 controller: (FeedbackController | ControllerConfig
                              | None) = None,
                 mesh=None, device=None, sleep=time.sleep):
        if max_coalesce <= 0:
            raise ValueError("max_coalesce must be positive")
        if coalesce_window_s < 0:
            raise ValueError("coalesce_window_s must be >= 0")
        if pipeline_depth <= 0:
            raise ValueError("pipeline_depth must be positive")
        if layout_workers <= 0:
            raise ValueError("layout_workers must be positive")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        # `device` goes to the session made here when none is given:
        # `None` -> cuda (raises without a CUDA device), "cpu" for the
        # plain path; a given session keeps its own device.  `mesh`
        # forwards to the session's device-mesh explore engine (positions,
        # an int device cap, or True); with a given session it overrides
        # that session's knob only when set
        self.session = session or DesignSession(device=device)
        if mesh is not None:
            self.session.mesh = mesh
        self.max_coalesce = max_coalesce
        self.coalesce_window_s = coalesce_window_s
        # bound of the batch-granular explore/distill queues: how many
        # coalesced batches may be in flight ahead of (and including)
        # the explore stage — the pipeline's lookahead and the
        # admission backpressure.  The bucket-granular layout queue and
        # the finalize queue are UNBOUNDED: retries, shed duplicates,
        # and crashed-worker re-queues put into them from inside the
        # pool, and a bounded put there could deadlock the very workers
        # that are supposed to drain it.
        self.pipeline_depth = pipeline_depth
        self.layout_workers = layout_workers
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.retry_backoff_cap_s = retry_backoff_cap_s
        self.retry_jitter = retry_jitter
        self.worker_restarts = worker_restarts
        self._straggler = straggler
        self._guard = guard
        self._injector = injector
        self._sleep = sleep
        self._rng = random.Random(0xAC1)   # jitter; determinism for tests
        # telemetry: the metrics registry is ALWAYS present (metrics()
        # must work out of the box); span recording is opt-in — an
        # unattached recorder costs one `is None` branch per event
        if telemetry is True:
            telemetry = Telemetry()
        self.telemetry = telemetry or None
        self.recorder = telemetry.recorder if telemetry else None
        self.registry = (telemetry.metrics if telemetry
                         else MetricsRegistry())
        if isinstance(controller, ControllerConfig):
            controller = FeedbackController(controller,
                                            recorder=self.recorder)
        if controller is not None and controller.recorder is None:
            controller.recorder = self.recorder
        self.controller = controller
        if controller is not None:
            cfg = controller.config
            if cfg.target_batch is None:
                controller.config = dataclasses.replace(
                    cfg, target_batch=max_coalesce)
            self.layout_workers = max(min(layout_workers,
                                          cfg.max_workers),
                                      cfg.min_workers)
        if (self.recorder is not None
                and getattr(self.session, "recorder", None) is None):
            self.session.recorder = self.recorder  # session-level spans too
        self._arrivals_total = 0     # monotonic submit() count (controller)
        self._batch_seq = 0          # admission sequence (span tag)
        self._next_wid = layout_workers   # next grown worker's id
        if journal is None:
            cache = getattr(self.session, "artifact_cache", None)
            if cache is not None and hasattr(cache, "root"):
                journal = TicketJournal.beside(cache)
        elif not isinstance(journal, TicketJournal):
            journal = TicketJournal(journal)
        self.journal = journal
        self._lock = make_lock("DesignService._lock")
        self._work = make_condition(self._lock)   # queue grew / closing
        self._done_cv = make_condition(self._lock)  # artifacts landed
        # serializes session access on the synchronous run()/step() path;
        # the pipelined path instead relies on the stage partition of
        # session state (module docstring) and refuses run()/step() while
        # a pump is active
        self._dispatch = make_lock("DesignService._dispatch")
        self._queue: list[tuple[int, DesignRequest, float]] = []
        self._pending: set[int] = set()   # issued, not yet in `done`
        self._next_ticket = 0
        self.done: dict[int, DesignArtifact] = {}
        self._pump: threading.Thread | None = None
        self._sync_dispatchers = 0   # run()/step() drains in progress
        self._stage_threads: list[threading.Thread] = []
        self._queues: dict[str, queue.Queue] = {}
        self._redo: dict[str, collections.deque] = {}  # crashed-worker units
        self._inflight: list[_Batch] = []   # admitted, not yet finalized
        self._inflight_buckets: dict = {}   # worker id -> (batch, bucket,
        #                                     started_at, attempt)
        self._layout_live = 0        # pool workers yet to see the sentinel
        self._bucket_seq = 0         # completed-bucket counter for the EMA
        self._injector_units: collections.Counter = collections.Counter()
        self._watchdog: threading.Thread | None = None
        self._watchdog_stop = threading.Event()
        self._watchdog_poll_s = 0.02
        self._replayed: set[int] = set()   # tickets resubmitted from the WAL
        self._preempted = False
        self._pipelined = False
        self._closing = False
        self._pump_error: BaseException | None = None
        # occupancy clocks (under self._lock): refcount + first-busy
        # timestamp per stage (the layout clock is shared by the pool:
        # busy while ANY pool worker is), cumulative busy seconds, and
        # the explore∧layout overlap clock
        self._busy_n: collections.Counter = collections.Counter()
        self._busy_since: dict[str, float] = {}
        self._busy_s: collections.Counter = collections.Counter()
        self._overlap_since: float | None = None
        self._overlap_s = 0.0
        self._register_metrics()

    # -- accounting ------------------------------------------------------
    def _register_metrics(self) -> None:
        """Wire the typed registry over the live service state.

        Counters that pre-date the registry (the `session.stats` family)
        are registered as `fn`-proxies over those very keys — one source
        of truth, `stats()` stays the thin compatibility view.  Gauges
        sample the pipeline live (open busy clocks flushed, exactly as
        `stats()` reports them).  The two histograms (`observe()`-driven,
        not proxied) are the registry's own: ticket end-to-end latency
        and per-bucket layout seconds."""
        reg = self.registry

        def stat(key):
            def sample(key=key):
                with self.session.stats_lock:
                    return self.session.stats.get(key, 0)
            return sample

        for key, help_ in (
                ("explorer_dispatches", "explorer DSE dispatches"),
                ("mesh_dispatches", "device-mesh explorer dispatches"),
                ("layout_dispatches", "layout solver dispatches"),
                ("artifact_cache_l1_hits", "tiered-cache L1 (local disk) "
                                           "hits"),
                ("artifact_cache_l1_misses", "tiered-cache L1 misses"),
                ("artifact_cache_l2_hits", "tiered-cache L2 (remote "
                                           "store) hits"),
                ("artifact_cache_l2_misses", "tiered-cache L2 misses"),
                ("artifact_cache_promotions", "L2 hits promoted into L1"),
                ("artifact_cache_l2_writes", "artifacts written through "
                                             "to the L2 store"),
                ("run_cell_traces", "cell-level trace evaluations"),
                ("service_batches", "coalesced batches completed"),
                ("service_batch_requests", "requests in completed batches"),
                ("bucket_retries", "layout bucket retry attempts"),
                ("bucket_failures", "layout buckets failed terminally"),
                ("bucket_cancellations", "settled-bucket duplicates "
                                         "cancelled on observe"),
                ("shed_buckets", "straggler buckets shed to a peer"),
                ("shed_losses", "shed races lost by the original worker"),
                ("stage_worker_restarts", "supervised stage-worker "
                                          "restarts"),
                ("preemptions", "preemption drains"),
                ("journaled_tickets", "tickets written to the WAL"),
                ("control_window_updates", "controller coalescing-window "
                                           "actuations"),
                ("pool_scale_ups", "layout pool grow actuations"),
                ("pool_scale_downs", "layout pool shrink actuations")):
            reg.counter(f"design_{key}_total", help_, fn=stat(key))
        for stage in _STAGES:
            reg.counter("design_stage_retries_total",
                        "batch-stage retry attempts",
                        labels={"stage": stage},
                        fn=stat(f"{stage}_stage_retries"))
            reg.counter("design_stage_failures_total",
                        "batch-stage terminal failures",
                        labels={"stage": stage},
                        fn=stat(f"{stage}_stage_failures"))
        for tier in ("artifact_cache", "artifact_cache_l1",
                     "artifact_cache_l2", "memo", "explorer", "pipeline",
                     "journal_replay", "error"):
            reg.counter("design_tickets_served_total",
                        "tickets landed, by provenance tier",
                        labels={"tier": tier})

        def locked(fn):
            def sample():
                with self._lock:
                    return fn()
            return sample

        reg.gauge("design_queue_depth",
                  "submissions not yet admitted to a batch",
                  fn=locked(lambda: len(self._queue)))
        reg.gauge("design_inflight_batches",
                  "batches admitted, not yet finalized",
                  fn=locked(lambda: len(self._inflight)))
        reg.gauge("design_inflight_buckets",
                  "buckets running in the layout pool",
                  fn=locked(lambda: len(self._inflight_buckets)))
        reg.gauge("design_layout_workers", "live layout pool width",
                  fn=locked(lambda: self.layout_workers))
        reg.gauge("design_coalesce_window_s",
                  "live admission coalescing window",
                  fn=locked(lambda: self.coalesce_window_s))
        reg.gauge("design_pump_alive", "serve() pump liveness",
                  fn=locked(lambda: float(self._pump_alive())))
        for stage in _STAGES:
            def depth(s=stage):
                q = self._queues.get(s)
                return q.qsize() if q is not None else 0
            reg.gauge("design_stage_queue_depth", "items waiting per stage",
                      labels={"stage": stage}, fn=locked(depth))
            reg.gauge("design_stage_busy", "stage occupancy (workers busy)",
                      labels={"stage": stage},
                      fn=locked(lambda s=stage: self._busy_n[s]))
            reg.gauge("design_stage_busy_seconds",
                      "cumulative busy time per stage (open clock flushed)",
                      labels={"stage": stage},
                      fn=locked(
                          lambda s=stage: self._busy_snapshot()[0][s]))
        reg.gauge("design_pipeline_overlap_seconds",
                  "wall-clock with explore and layout busy simultaneously",
                  fn=locked(lambda: self._busy_snapshot()[1]))
        self._ticket_latency = reg.histogram(
            "design_ticket_latency_seconds",
            "submit() -> artifact landed, per ticket")
        self._bucket_seconds = reg.histogram(
            "design_bucket_layout_seconds",
            "layout solve wall-clock per bucket attempt")

    def metrics(self) -> dict:
        """The versioned metrics snapshot (`METRICS_SCHEMA`): every
        registered counter/gauge/histogram sampled NOW — callbacks read
        the live pipeline state under the service lock, open busy
        clocks flushed.  Render with
        `repro_torch.telemetry.export.render_prometheus`, persist with
        `write_metrics_json`."""
        return self.registry.snapshot()

    def trace(self) -> TraceExport | None:
        """Export the span trace (open spans flushed) — `None` unless
        the service was built with `telemetry=`."""
        if self.recorder is None:
            return None
        return self.recorder.export()
    def stats(self) -> dict:
        """A point-in-time **snapshot** of counters and pipeline gauges.

        Returns a fresh dict each call (taken under the service lock) —
        mutating it cannot corrupt the service, unlike the live Counter
        view this used to be.  Counter keys come from the session
        (`explorer_dispatches`, `layout_dispatches`, cache hits/misses,
        `service_batches`/`service_batch_requests`, the fault-tolerance
        family listed in the module docstring, ...); gauge keys:

          * `queue_depth` — submissions not yet admitted to a batch;
          * `inflight_batches` — admitted, not yet finalized;
          * `inflight_buckets` — buckets running in the layout pool;
          * `done_count`, `pump_alive`, `pipelined`, `layout_workers`,
            `preempted`, `replayed_tickets`;
          * `stage_queue_depth` / `stage_busy` / `stage_busy_s` — per
            stage: items waiting, busy right now, cumulative busy time;
          * `pipeline_overlap_s` — wall-clock during which the explore
            and layout stages were busy *simultaneously*, and
            `pipeline_overlap_fraction` — that, over the smaller of the
            two stages' busy time (0.0 when either never ran).

        The snapshot is a `collections.Counter` copy, so counter keys
        that never fired read as 0 instead of raising."""
        with self._lock:
            # the counters have their own writer lock (stage workers
            # bump() concurrently); copy under it so a new-key insert
            # cannot resize the dict mid-iteration.  Order is always
            # _lock -> stats_lock, matching every bump() under _lock.
            with self.session.stats_lock:
                snap = collections.Counter(self.session.stats)
            snap["queue_depth"] = len(self._queue)
            snap["inflight_batches"] = len(self._inflight)
            snap["inflight_buckets"] = len(self._inflight_buckets)
            snap["done_count"] = len(self.done)
            snap["pump_alive"] = self._pump_alive()
            snap["pipelined"] = self._pipelined
            snap["layout_workers"] = self.layout_workers
            snap["preempted"] = self._preempted
            snap["replayed_tickets"] = len(self._replayed)
            snap["stage_queue_depth"] = {
                s: (self._queues[s].qsize() if s in self._queues else 0)
                for s in _STAGES}
            snap["stage_busy"] = {s: self._busy_n[s] > 0 for s in _STAGES}
            busy_s, overlap = self._busy_snapshot()
            snap["stage_busy_s"] = busy_s
            snap["pipeline_overlap_s"] = overlap
            floor = min(busy_s["explore"], busy_s["layout"])
            snap["pipeline_overlap_fraction"] = (overlap / floor
                                                 if floor > 0 else 0.0)
            return snap

    def _busy_snapshot(self) -> tuple[dict, float]:
        """Lock held.  Per-stage cumulative busy seconds and the
        explore∧layout overlap clock, with OPEN clocks flushed at the
        current time — a mid-batch `stats()` or `metrics()` reports
        in-progress stage time, never a stale closed total.  The one
        flushing path shared by the `stats()` compatibility view and
        the registry gauges."""
        now = time.monotonic()
        busy_s = {s: self._busy_s[s]
                  + (now - self._busy_since[s]
                     if s in self._busy_since else 0.0)
                  for s in _STAGES}
        overlap = self._overlap_s + (now - self._overlap_since
                                     if self._overlap_since is not None
                                     else 0.0)
        return busy_s, overlap

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- submission ------------------------------------------------------
    def submit(self, request: DesignRequest) -> int:
        """Enqueue a request; returns the ticket to collect its artifact.

        Thread-safe; wakes the `serve()` pump (if running) so the
        coalescing window starts counting from the oldest queued request."""
        with self._lock:
            if self._closing:
                raise RuntimeError("DesignService is closing; "
                                   "no new submissions accepted")
            if self._preempted:
                raise RuntimeError(
                    "DesignService was preempted; unfinished tickets are "
                    "journaled — collect the drained artifacts, then replay "
                    "the journal from a fresh service (serve() replays it "
                    "automatically)")
            if self._pump_error is not None:
                # nothing will serve this ticket: the pipeline stopped.
                # Refuse admission until close() surfaces (and clears)
                # the error.
                raise RuntimeError(
                    "DesignService serve() pump failed; call close() to "
                    "surface the error (in-flight batches are restored to "
                    "the queue), then serve() or run() again"
                ) from self._pump_error
            ticket = self._next_ticket
            self._next_ticket += 1
            self._arrivals_total += 1   # controller's rate-EMA source
            self._queue.append((ticket, request, time.monotonic()))
            self._pending.add(ticket)
            self._work.notify_all()
        return ticket

    # -- synchronous drain -----------------------------------------------
    def step(self) -> dict[int, DesignArtifact]:
        """Dispatch one coalesced batch (up to `max_coalesce` requests) and
        return its per-ticket artifacts.

        A request whose requirements remove every Pareto point cannot
        poison the batch: it completes with `artifact.error` set (the
        session's non-strict mode) while the other tenants are served.
        On an unexpected exception the batch is restored — in order, at
        the front of the queue — so no tenant's submission is lost.

        Not valid while a `serve()` pump is running: the pump's stage
        workers are the only dispatchers — use `collect()`/`poll()`."""
        self._begin_sync("step")
        try:
            return self._dispatch_once()
        finally:
            self._end_sync()

    def _begin_sync(self, name: str) -> None:
        """Claim the session for a synchronous run()/step() drain.  Taken
        under the lock so the serve()-vs-sync mutual exclusion is not a
        check-then-act race: serve() refuses while a drain is active,
        and a drain refuses while a pump is alive."""
        with self._lock:
            if self._pump_alive():
                raise RuntimeError(f"{name}() while the serve() pump is "
                                   f"active; the pump is the only "
                                   f"dispatcher — use collect()/poll() "
                                   f"instead")
            self._sync_dispatchers += 1

    def _end_sync(self) -> None:
        with self._lock:
            self._sync_dispatchers -= 1

    def _dispatch_once(self) -> dict[int, DesignArtifact]:
        with self._lock:
            batch = self._queue[:self.max_coalesce]
            del self._queue[:self.max_coalesce]
        if not batch:
            return {}
        try:
            with self._dispatch:
                artifacts = self.session.run_many([r for _, r, _ in batch],
                                                  bucket_layouts=True,
                                                  strict=False)
        except Exception:
            with self._lock:
                self._queue[:0] = batch
                self._work.notify_all()
            raise
        out = {ticket: artifacts[r] for ticket, r, _ in batch}
        self._complete(out, entries=batch)
        return out

    def run(self) -> dict[int, DesignArtifact]:
        """Drain the whole queue synchronously; returns a snapshot of every
        completed (uncollected) ticket.  Not valid while a `serve()` pump
        is running — use `collect()`/`poll()` there."""
        self._begin_sync("run")
        try:
            while self._dispatch_once():
                pass
        finally:
            self._end_sync()
        with self._lock:
            return dict(self.done)

    # -- ticket lifecycle ------------------------------------------------
    def _check_known(self, ticket: int) -> None:
        # lock held
        if not 0 <= ticket < self._next_ticket:
            raise UnknownTicket(f"ticket {ticket} was never issued by this "
                                f"service (tickets 0..{self._next_ticket - 1})")
        if ticket not in self._pending and ticket not in self.done:
            raise UnknownTicket(f"ticket {ticket} was already collected "
                                f"(use collect(..., keep_done=True) to keep "
                                f"artifacts around)")

    def poll(self, ticket: int) -> DesignArtifact | None:
        """Non-blocking, non-destructive readiness probe: the artifact if
        ready, `None` while the ticket is still queued / in flight.
        Raises `UnknownTicket` for a ticket this service never issued, and
        (like `collect`) surfaces a dead pipeline as `RuntimeError` — a
        poll-only consumer must not spin forever on a ticket that nothing
        is going to serve."""
        with self._lock:
            self._check_known(ticket)
            art = self.done.get(ticket)
            if art is None and self._pump_error is not None:
                raise RuntimeError(
                    f"ticket {ticket} cannot complete: the serve() pump "
                    f"failed (close() restores in-flight batches to the "
                    f"queue; drain with run()/step() or serve() again)"
                ) from self._pump_error
            if art is None and self._preempted and not self._pump_alive():
                raise PendingTicket(
                    f"ticket {ticket} was journaled by a preemption drain; "
                    f"replay the journal from a fresh service")
            return art

    def collect(self, ticket: int, *, timeout: float | None = None,
                keep_done: bool = False) -> DesignArtifact:
        """Return (and pop) the ticket's artifact.

        With a `serve()` pump running — or a `timeout` given — blocks
        until the artifact lands, the timeout expires (`PendingTicket`),
        or the pipeline fails (`RuntimeError` chaining the stage's
        exception; `close()` restores the in-flight batches).  Without a
        pump and without a timeout, a still-pending ticket raises
        `PendingTicket` immediately instead of deadlocking — drain with
        `run()`/`step()`.  A ticket journaled by a preemption drain
        raises `PendingTicket` once the drain finishes: its artifact
        belongs to the replaying service.

        Popping on collect keeps `done` bounded in a long-lived service;
        pass `keep_done=True` to leave the artifact collectable again."""
        deadline = (None if timeout is None
                    else time.monotonic() + max(timeout, 0.0))
        with self._lock:
            while True:
                self._check_known(ticket)
                art = self.done.get(ticket)
                if art is not None:
                    if not keep_done:
                        del self.done[ticket]
                    return art
                if self._pump_error is not None:
                    raise RuntimeError(
                        f"ticket {ticket} cannot complete: the serve() pump "
                        f"failed (close() restores in-flight batches to the "
                        f"queue; drain with run()/step() or serve() again)"
                    ) from self._pump_error
                if self._preempted and not self._pump_alive():
                    raise PendingTicket(
                        f"ticket {ticket} was journaled by a preemption "
                        f"drain; replay the journal from a fresh service")
                if deadline is None and not self._pump_alive():
                    raise PendingTicket(
                        f"ticket {ticket} is still pending and no serve() "
                        f"pump is running; drain the queue with run()/step() "
                        f"or pass collect(..., timeout=...) under serve()")
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise PendingTicket(f"ticket {ticket} still pending "
                                        f"after {timeout:g}s")
                # bounded wait so a pump that dies without notifying
                # (or a run()-mode caller) cannot strand us
                self._done_cv.wait(timeout=0.1 if remaining is None
                                   else min(remaining, 0.1))

    def _complete(self, out: dict[int, DesignArtifact],
                  batch: _Batch | None = None, entries=None) -> None:
        """Land a finished batch's artifacts: journal-replay re-stamp,
        done/pending bookkeeping, service counters, ticket-latency /
        served-tier metrics (when `entries` carries the submit stamps),
        wakeups."""
        now = time.monotonic()
        with self._lock:
            for t in list(out):
                if t in self._replayed:
                    a = out[t]
                    out[t] = dataclasses.replace(
                        a, provenance=dataclasses.replace(
                            a.provenance, served_from="journal_replay"))
            self.done.update(out)
            self._pending.difference_update(out)
            self.session.bump("service_batches")
            self.session.bump("service_batch_requests", len(out))
            if batch is not None and batch in self._inflight:
                self._inflight.remove(batch)
            self._done_cv.notify_all()
        if entries is None and batch is not None:
            entries = batch.entries
        for ticket, _, t_submit in entries or ():
            art = out.get(ticket)
            if art is None:
                continue
            self._ticket_latency.observe(now - t_submit)
            tier = getattr(art.provenance, "served_from", None)
            if art.error is not None:
                tier = "error"
            if tier:
                self.registry.counter("design_tickets_served_total",
                                      labels={"tier": str(tier)}).inc()

    # -- preemption + journal replay -------------------------------------
    def replay_journal(self) -> list[int]:
        """Resubmit every journaled request (admission order preserved)
        and return their new tickets; their artifacts will be re-stamped
        `served_from="journal_replay"`.  The journal is cleared only
        AFTER the resubmissions are safely in the queue — a crash in
        between replays again instead of losing tickets.  `serve()`
        calls this automatically; explicit calls suit the synchronous
        `run()` path.  No-op (`[]`) without a journal or with an empty
        one."""
        if self.journal is None:
            return []
        requests = self.journal.replay()
        if not requests:
            return []
        tickets = [self.submit(r) for r in requests]
        with self._lock:
            self._replayed.update(tickets)
        self.journal.clear()
        if self.recorder is not None:
            self.recorder.instant("journal_replay", cat="fault",
                                  tickets=len(tickets))
        return tickets

    def _preempt_drain(self) -> None:
        """The pump's reaction to `guard.preempted`: journal every
        unfinished ticket (queued AND in-flight — if the drain itself is
        killed, replay still recovers them; drained work is served from
        the artifact cache on replay), stop admitting, and let the
        already-admitted batches run to completion."""
        drain_span = (None if self.recorder is None
                      else self.recorder.begin("preempt_drain", cat="fault"))
        with self._lock:
            self._preempted = True
            entries = sorted((e for b in self._inflight for e in b.entries),
                             key=lambda e: e[0])
            entries += self._queue   # queued-after-inflight, already ordered
            self.session.bump("preemptions")
        n = 0
        if self.journal is not None and entries:
            n = self.journal.write([r for _, r, _ in entries])
        with self._lock:
            self.session.bump("journaled_tickets", n)
            self._done_cv.notify_all()   # waiters re-evaluate (PendingTicket)
        if drain_span is not None:
            drain_span.args["journaled"] = n
            self.recorder.end(drain_span)

    # -- the staged pipeline ---------------------------------------------
    def _pump_alive(self) -> bool:
        # the pipeline is "alive" (able to complete tickets) while the
        # admission pump runs OR any stage worker is still draining —
        # during close() the pump exits first but finalize keeps landing
        # artifacts, and collectors must not see a dead service then
        pump = self._pump
        if pump is not None and pump.is_alive():
            return True
        return any(t.is_alive() for t in self._stage_threads)

    def serve(self, *, pipelined: bool = True) -> "DesignService":
        """Start the serve pump (idempotent); returns `self` so
        `with DesignService(...).serve() as svc:` reads naturally.

        `pipelined=True` (default) starts the staged pipeline executor:
        admission pump + explore/distill/finalize workers and the
        `layout_workers`-wide layout pool, overlapping consecutive
        batches and streaming layout buckets.  `pipelined=False` is the
        serial pump (one thread, one coalesced batch at a time through
        `run_many`) — kept for comparison and as a minimal fallback.

        Idempotent for the same mode; asking for the *other* mode while
        a pump is alive raises (close() first to switch).  If a journal
        holds tickets from a preempted predecessor, they are replayed
        (resubmitted, in order) before this call returns."""
        with self._lock:
            if self._pump_alive():
                if pipelined != self._pipelined:
                    mode = "pipelined" if self._pipelined else "serial"
                    raise RuntimeError(
                        f"serve(pipelined={pipelined}) while a {mode} pump "
                        f"is already running; close() first to switch modes")
                return self
            if self._closing:
                # a concurrent close() is joining the old pump; starting a
                # second one here would orphan that drain (and race two
                # dispatchers on the session)
                raise RuntimeError("serve() while close() is in progress; "
                                   "wait for close() to return")
            if self._sync_dispatchers:
                # the converse of the step()/run() refusal: a synchronous
                # drain is mid-flight on the session, and the stage
                # workers must not race it
                raise RuntimeError("serve() while a run()/step() drain is "
                                   "in progress; wait for it to return")
            if self._guard is not None and self._guard.preempted:
                raise RuntimeError(
                    "serve() with a guard whose preemption is already "
                    "requested; a preempted service stays drained — replay "
                    "its journal from a fresh service (fresh guard)")
            self._pump_error = None
            self._pipelined = pipelined
            if pipelined:
                d = self.pipeline_depth
                self._queues = {"explore": queue.Queue(maxsize=d),
                                "distill": queue.Queue(maxsize=d),
                                "layout": queue.Queue(),    # unbounded: pool
                                "finalize": queue.Queue()}  # retries re-put
                self._redo = {s: collections.deque() for s in _STAGES}
                self._layout_live = self.layout_workers
                self._next_wid = self.layout_workers
                self._stage_threads = [
                    threading.Thread(target=self._stage_worker,
                                     args=("explore", None),
                                     name="design-service-explore",
                                     daemon=True),
                    threading.Thread(target=self._stage_worker,
                                     args=("distill", None),
                                     name="design-service-distill",
                                     daemon=True),
                    *(threading.Thread(target=self._stage_worker,
                                       args=("layout", w),
                                       name=f"design-service-layout-{w}",
                                       daemon=True)
                      for w in range(self.layout_workers)),
                    threading.Thread(target=self._stage_worker,
                                     args=("finalize", None),
                                     name="design-service-finalize",
                                     daemon=True)]
                for t in self._stage_threads:
                    t.start()
                if self._straggler is not None and self.layout_workers > 1:
                    self._watchdog_stop.clear()
                    self._watchdog = threading.Thread(
                        target=self._watchdog_loop,
                        name="design-service-watchdog", daemon=True)
                    self._watchdog.start()
            self._pump = threading.Thread(target=self._pump_loop,
                                          name="design-service-pump",
                                          daemon=True)
            self._pump.start()
        self.replay_journal()
        return self

    def _pump_loop(self) -> None:
        """Admission: wait out the coalescing window, then either hand the
        batch to the explore queue (pipelined) or dispatch it inline
        (serial).  With a guard attached, waits are bounded so a
        preemption request is noticed within ~0.1s even on an idle
        queue."""
        pipelined = self._pipelined
        caps = []
        if self._guard is not None:
            caps.append(0.1)
        if self.controller is not None and pipelined:
            # bounded waits guarantee a controller tick at least every
            # tick_interval_s even on an idle queue
            caps.append(self.controller.config.tick_interval_s)
        cap = min(caps) if caps else None
        try:
            while True:
                preempt = False
                with self._lock:
                    while True:
                        if pipelined:
                            self._control_tick()
                        if (self._guard is not None and self._guard.preempted
                                and not self._preempted):
                            preempt = True
                            break
                        if self._pump_error is not None:
                            # a stage failed: stop forming batches and
                            # wait for close() to restore + surface
                            if self._closing:
                                return
                            self._work.wait(timeout=0.1)
                            continue
                        if self._closing:
                            if not self._queue:
                                return          # graceful: queue drained
                            break               # final drain dispatches
                        n = len(self._queue)
                        if n >= self.max_coalesce:
                            break               # batch is full
                        if n:
                            oldest = self._queue[0][2]
                            wait = (self.coalesce_window_s
                                    - (time.monotonic() - oldest))
                            if wait <= 0:
                                break           # deadline of oldest request
                            self._work.wait(timeout=wait if cap is None
                                            else min(wait, cap))
                        else:
                            self._work.wait(timeout=cap)
                if preempt:
                    self._preempt_drain()
                    return
                if pipelined:
                    self._admit_batch()
                else:
                    self._dispatch_once()
        except Exception as e:   # serial path; _dispatch_once restored it
            with self._lock:
                self._pump_error = e
                self._done_cv.notify_all()
        finally:
            if pipelined:
                # one sentinel, forwarded stage to stage (fanned out
                # across the pool at layout), drains and stops the whole
                # chain in order
                self._queues["explore"].put(None)

    def _admit_batch(self) -> None:
        with self._lock:
            entries = self._queue[:self.max_coalesce]
            del self._queue[:self.max_coalesce]
            if not entries:
                return
            batch = _Batch(entries, seq=self._batch_seq)
            self._batch_seq += 1
            self._inflight.append(batch)
            # snapshot under the lock: the controller retunes the window
            # from the pump thread
            window_s = self.coalesce_window_s
        if self.recorder is not None:
            self.recorder.instant(
                "admit", cat="pump", batch=batch.seq, at=batch.admitted_at,
                requests=len(entries),
                oldest_wait_s=round(batch.admitted_at - entries[0][2], 6),
                window_s=window_s)
        self._inject("admit")
        # blocking put = backpressure: at most `pipeline_depth` batches
        # queue ahead of the explore stage; never block under the lock
        self._queues["explore"].put(batch)

    @contextlib.contextmanager
    def _stage(self, name: str, *, batch: int | None = None,
               bucket=None, worker: str | None = None):
        """Occupancy bookkeeping (and, with a recorder, a `cat="stage"`
        span) around one unit of stage work.  The span edges share the
        busy clocks' exact `time.monotonic()` reads, so per-stage span
        sums and `stage_busy_s` agree to float precision for
        single-occupant stages — not merely within scheduling jitter."""
        t0 = time.monotonic()
        with self._lock:
            self._mark(name, busy=True, now=t0)
        span = (None if self.recorder is None
                else self.recorder.begin(name, cat="stage", batch=batch,
                                         bucket=bucket, worker=worker,
                                         at=t0))
        try:
            yield
        finally:
            t1 = time.monotonic()
            with self._lock:
                self._mark(name, busy=False, now=t1)
            if span is not None:
                self.recorder.end(span, at=t1)

    def _mark(self, name: str, *, busy: bool,
              now: float | None = None) -> None:
        # lock held.  Maintains per-stage busy clocks and the
        # explore∧layout overlap clock (the pipelining win is exactly the
        # wall-clock both are busy at once).  Refcounted: the layout pool
        # has K concurrent occupants of one clock — it runs from the
        # first worker going busy to the last going idle.
        if now is None:
            now = time.monotonic()
        if busy:
            self._busy_n[name] += 1
            if self._busy_n[name] == 1:
                self._busy_since[name] = now
        else:
            self._busy_n[name] -= 1
            if self._busy_n[name] == 0:
                self._busy_s[name] += now - self._busy_since.pop(name)
        both = "explore" in self._busy_since and "layout" in self._busy_since
        if both and self._overlap_since is None:
            self._overlap_since = now
        elif not both and self._overlap_since is not None:
            self._overlap_s += now - self._overlap_since
            self._overlap_since = None

    def _fatal(self, exc: BaseException) -> None:
        """Terminal pipeline failure (a worker exhausted its restart
        budget): stop the pipeline, wake everyone.  The in-flight batches
        are restored to the queue front by close()."""
        with self._lock:
            if self._pump_error is None:
                self._pump_error = exc
            self._work.notify_all()     # admission: stop forming batches
            self._done_cv.notify_all()  # collectors: surface the error

    def _inject(self, stage: str) -> None:
        """Fire the failure injector for the next `stage` unit.  The unit
        counter is monotonic per stage — a retried unit gets a NEW index,
        so a scheduled injection fires exactly once.  Never called under
        the lock: `slow` injections sleep."""
        if self._injector is None:
            return
        with self._lock:
            unit = self._injector_units[stage]
            self._injector_units[stage] += 1
        self._injector.fire(stage, unit)

    def _attempt(self, stage: str, call, batch: int | None = None):
        """Run a batch-granular stage call under the retry budget:
        `(value, None)` on success, `(None, message)` once the budget is
        exhausted.  Backoff between attempts is capped-exponential with
        jitter, through the injectable `sleep`."""
        last: BaseException | None = None
        for attempt in range(1, self.max_retries + 2):
            try:
                self._inject(stage)
                return call(), None
            except Exception as e:
                last = e
                with self._lock:
                    if attempt <= self.max_retries:
                        self.session.bump(f"{stage}_stage_retries")
                    else:
                        self.session.bump(f"{stage}_stage_failures")
                if self.recorder is not None:
                    self.recorder.instant(
                        "stage_retry" if attempt <= self.max_retries
                        else "stage_failure",
                        cat="fault", batch=batch, stage=stage,
                        attempt=attempt, error=repr(e))
                if attempt <= self.max_retries:
                    self._sleep(capped_backoff(
                        attempt, base_s=self.retry_backoff_s,
                        cap_s=self.retry_backoff_cap_s,
                        jitter_frac=self.retry_jitter, rng=self._rng))
        return None, (f"{stage} stage failed after {self.max_retries + 1} "
                      f"attempt(s): {last!r}")

    # -- supervised stage workers ----------------------------------------
    def _stage_worker(self, stage: str, wid: int | None) -> None:
        """Thread target: the stage loop under `run_supervised`.  A crash
        inside the loop re-queues the in-hand unit (via the redo deque —
        never a bounded-queue put, which could deadlock) and restarts the
        loop in-process, with backoff, until `worker_restarts` is spent.
        An exhausted budget is terminal: flag the pipeline down, then
        keep consuming as a sink so upstream blocked puts and the
        sentinel chain still drain (close() restores the batches)."""
        q_in = self._queues[stage]

        def attempt() -> int:
            self._worker_loop(stage, wid)
            return 0

        def count_restart(n: int) -> None:
            with self._lock:
                self.session.bump("stage_worker_restarts")

        try:
            run_supervised(attempt, max_restarts=self.worker_restarts,
                           restart_on=(Exception,),
                           backoff_s=self.retry_backoff_s,
                           backoff_cap_s=self.retry_backoff_cap_s,
                           sleep=self._sleep, on_restart=count_restart)
        except BaseException as e:
            self._fatal(e)
            while True:
                item = q_in.get()
                if item is None or item is _SHRINK:
                    # a shrink token retires this sink exactly like the
                    # close sentinel would: the live count (and with it
                    # the finalize sentinel) must stay conserved
                    self._propagate_sentinel(stage)
                    return

    def _worker_loop(self, stage: str, wid: int | None) -> None:
        """One supervised incarnation of a stage worker: pull a unit
        (crashed-in-hand units first), process it, repeat until the
        sentinel."""
        q_in, redo = self._queues[stage], self._redo[stage]
        while True:
            try:
                item = redo.popleft()
            except IndexError:
                item = q_in.get()
            if item is None:
                self._propagate_sentinel(stage)
                return
            if item is _SHRINK:
                # controller scale-down: exactly one worker retires.
                # Same bookkeeping as the close sentinel — decrement the
                # live count, fire the finalize sentinel if we were last
                # (a shrink token can race close(): whichever of the two
                # terminal tokens this worker consumes, the other goes
                # to a peer, and the counts conserve)
                self._propagate_sentinel(stage)
                if self.recorder is not None:
                    self.recorder.instant("pool_shrink", cat="control",
                                          worker=f"layout-{wid}")
                return
            with self._lock:
                failed = self._pump_error is not None
            if failed:
                continue   # skip; close() restores it from _inflight
            try:
                if stage == "explore":
                    self._process_explore(item)
                elif stage == "distill":
                    self._process_distill(item)
                elif stage == "layout":
                    self._process_layout(item, wid)
                else:
                    self._process_finalize(item)
            except Exception:
                # the worker loop itself crashed (stage-call failures are
                # already isolated inside the _process_* handlers): park
                # the unit for the restarted incarnation and let the
                # supervisor take it from here
                redo.append(item)
                raise

    def _propagate_sentinel(self, stage: str) -> None:
        if stage == "explore":
            self._queues["distill"].put(None)
        elif stage == "distill":
            with self._lock:   # pool width is autoscaled from the pump
                width = self.layout_workers
            for _ in range(width):   # one per pool worker
                self._queues["layout"].put(None)
        elif stage == "layout":
            with self._lock:
                self._layout_live -= 1
                last = self._layout_live == 0
            if last:
                self._queues["finalize"].put(None)

    def _process_explore(self, batch: _Batch) -> None:
        start = time.monotonic()
        wait = start - batch.admitted_at
        batch.waits = {r: wait for _, r, _ in batch.entries}

        def call():
            with self._stage("explore", batch=batch.seq):
                return self.session.explore_stage(
                    [r for _, r, _ in batch.entries])

        value, err = self._attempt("explore", call, batch.seq)
        if err is not None:
            batch.error = err
        else:
            batch.explored = value
        self._queues["distill"].put(batch)

    def _process_distill(self, batch: _Batch) -> None:
        q_out = self._queues["layout"]
        if batch.error is None:
            def call():
                with self._stage("distill", batch=batch.seq):
                    return self.session.distill_stage(batch.explored,
                                                      strict=False)
            value, err = self._attempt("distill", call, batch.seq)
            if err is not None:
                batch.error = err
            else:
                batch.distilled = value
        if batch.error is not None or not batch.distilled.buckets:
            batch.remaining = 0
            q_out.put((batch, None, time.monotonic(), 1))
            return
        batch.remaining = len(batch.distilled.buckets)
        # stream: every bucket is submitted to the layout pool the
        # moment it exists — bucket 1 of batch N is routing while the
        # rest are still enqueuing and batch N+1 is exploring
        for bucket in batch.distilled.buckets:
            q_out.put((batch, bucket, time.monotonic(), 1))

    def _process_layout(self, item, wid: int | None) -> None:
        batch, bucket, t_enq, attempt = item
        q_out = self._queues["finalize"]
        if bucket is None:          # error batch / batch with no buckets
            q_out.put(batch)
            return
        key = bucket.key
        with self._lock:
            if key in batch.completed or key in batch.failed:
                # shed duplicate (or stale retry) of a settled bucket:
                # cancelled-on-observe before it even dispatched
                self.session.bump("bucket_cancellations")
                return
            self._inflight_buckets[wid] = (batch, bucket,
                                           time.monotonic(), attempt)
        wait = time.monotonic() - t_enq
        t0 = time.monotonic()
        try:
            self._inject("layout")
            with self._lock:
                if key in batch.completed or key in batch.failed:
                    # a shed peer settled it while a slow fault held us:
                    # cancel-on-observe without paying the dispatch
                    self._inflight_buckets.pop(wid, None)
                    self.session.bump("shed_losses")
                    return
            with self._stage("layout", batch=batch.seq, bucket=key,
                             worker=f"layout-{wid}"):
                res = self.session.layout_stage(bucket)
        except Exception as e:
            done = False
            with self._lock:
                self._inflight_buckets.pop(wid, None)
                if key in batch.completed or key in batch.failed:
                    # a shed peer settled it while we were failing
                    self.session.bump("bucket_cancellations")
                    return
                if attempt <= self.max_retries:
                    self.session.bump("bucket_retries")
                else:
                    self.session.bump("bucket_failures")
                    batch.failed[key] = (
                        f"layout bucket {key} failed after {attempt} "
                        f"attempt(s): {e!r}", attempt)
                    batch.remaining -= 1
                    done = batch.remaining == 0
            if self.recorder is not None:
                self.recorder.instant(
                    "bucket_retry" if attempt <= self.max_retries
                    else "bucket_failure",
                    cat="fault", batch=batch.seq, bucket=key,
                    worker=f"layout-{wid}", attempt=attempt, error=repr(e))
            if attempt <= self.max_retries:
                self._sleep(capped_backoff(
                    attempt, base_s=self.retry_backoff_s,
                    cap_s=self.retry_backoff_cap_s,
                    jitter_frac=self.retry_jitter, rng=self._rng))
                self._queues["layout"].put((batch, bucket, t_enq,
                                            attempt + 1))
            elif done:
                q_out.put(batch)
            return
        dt = time.monotonic() - t0
        self._bucket_seconds.observe(dt)
        with self._lock:
            self._inflight_buckets.pop(wid, None)
            if key in batch.completed or key in batch.failed:
                # first completion won already: we are the shed loser
                self.session.bump("shed_losses")
                return
            batch.completed.add(key)
            res.queue_wait_s = wait
            res.attempts = attempt
            res.shed = key in batch.shed
            res.worker_id = f"layout-{wid}"
            if self._straggler is not None:
                self._straggler.observe(self._bucket_seq, dt)
                self._bucket_seq += 1
            batch.results.append(res)
            batch.remaining -= 1
            done = batch.remaining == 0
        if done:                     # last bucket settled -> finalize
            q_out.put(batch)

    def _process_finalize(self, batch: _Batch) -> None:
        if batch.error is None:
            def call():
                with self._stage("finalize", batch=batch.seq):
                    return self.session.finalize_stage(
                        batch.distilled, batch.results, waits=batch.waits,
                        pipelined=True, failed=batch.failed or None)
            arts, err = self._attempt("finalize", call, batch.seq)
            if err is not None:
                batch.error = err
        if batch.error is not None:
            with self._stage("finalize", batch=batch.seq):
                arts = {r: self.session.error_artifact(
                            r, batch.error, pipelined=True,
                            explore_wait_s=batch.waits.get(r, 0.0))
                        for _, r, _ in batch.entries}
        out = {t: arts[r] for t, r, _ in batch.entries}
        self._complete(out, batch)

    # -- feedback control -------------------------------------------------
    def _control_tick(self) -> None:
        """Lock held (the admission pump is the single caller).  Feed
        the controller one observation window and apply its decision:
        ease `coalesce_window_s`, grow or shrink the layout pool by
        one.  Gated off while closing / failed — the sentinel chain's
        token conservation assumes no grow after the distill fan-out,
        and ticks stop strictly before the pump parks the explore
        sentinel."""
        c = self.controller
        if (c is None or self._closing or self._preempted
                or self._pump_error is not None
                or "layout" not in self._queues):
            return
        decision = c.tick(
            queue_depth=len(self._queue),
            arrivals_total=self._arrivals_total,
            layout_backlog=self._queues["layout"].qsize(),
            inflight_buckets=len(self._inflight_buckets),
            layout_workers=self.layout_workers,
            window_s=self.coalesce_window_s)
        if decision is None:
            return
        if abs(decision.window_s - self.coalesce_window_s) > 1e-12:
            self.coalesce_window_s = decision.window_s
            self.session.bump("control_window_updates")
        if decision.workers > self.layout_workers:
            self._grow_pool()
        elif decision.workers < self.layout_workers:
            self._shrink_pool()

    def _grow_pool(self) -> None:
        # lock held.  A grown worker is a full pool citizen: it joins
        # the live count (so the close sentinel fan-out stays conserved)
        # and close() joins it like the founders.
        wid = self._next_wid
        self._next_wid += 1
        self.layout_workers += 1
        self._layout_live += 1
        self.session.bump("pool_scale_ups")
        t = threading.Thread(target=self._stage_worker,
                             args=("layout", wid),
                             name=f"design-service-layout-{wid}",
                             daemon=True)
        self._stage_threads.append(t)
        t.start()

    def _shrink_pool(self) -> None:
        # lock held — safe only because the layout queue is unbounded.
        # `layout_workers` drops at ENQUEUE time (so the close fan-out
        # counts post-shrink workers) while `_layout_live` drops when a
        # worker actually consumes the token: live workers ==
        # layout_workers + pending shrink tokens, always.
        self.layout_workers -= 1
        self.session.bump("pool_scale_downs")
        self._queues["layout"].put(_SHRINK)

    # -- straggler shedding ----------------------------------------------
    def _watchdog_loop(self) -> None:
        """Poll the layout pool's in-flight buckets; one stuck past the
        monitor's `threshold x EMA` is shed — re-queued so a peer worker
        races the stuck incarnation, first completion wins."""
        while not self._watchdog_stop.wait(self._watchdog_poll_s):
            shed = []
            with self._lock:
                now = time.monotonic()
                for rec in list(self._inflight_buckets.values()):
                    batch, bucket, started, attempt = rec
                    key = bucket.key
                    if (key in batch.shed or key in batch.completed
                            or key in batch.failed):
                        continue   # one shed per bucket; settled is settled
                    if self._straggler.stuck(now - started):
                        batch.shed.add(key)
                        self._straggler.events.append(
                            ("shed", key, now - started,
                             self._straggler.ema))
                        self.session.bump("shed_buckets")
                        shed.append((batch, bucket, started, attempt))
            for item in shed:        # never put under the lock
                if self.recorder is not None:
                    b, bk, started, _ = item
                    self.recorder.instant(
                        "shed", cat="fault", batch=b.seq, bucket=bk.key,
                        stuck_s=round(time.monotonic() - started, 6))
                self._queues["layout"].put(item)

    def close(self) -> None:
        """Graceful shutdown: stop admitting, drain every queued batch
        through all stages, join the pump, the stage workers, and the
        shed watchdog.  Idempotent; a no-op if `serve()` was never
        called.  If the pipeline failed terminally, every in-flight
        batch is restored to the queue front (tickets intact, in
        admission order) and the exception is re-raised here.  After a
        preemption drain the journaled-but-unadmitted tickets stay in
        the queue for inspection; the journal already holds them for
        the replaying service."""
        with self._lock:
            pump = self._pump
            workers = list(self._stage_threads)
            watchdog = self._watchdog
            if pump is not None:
                self._closing = True
            self._work.notify_all()
        if pump is not None:
            # keep self._pump set while joining: a concurrent collect()
            # must still see a live pipeline (no spurious PendingTicket
            # during the final drain), and a concurrent serve() must not
            # start a second dispatcher (it sees _closing and refuses)
            pump.join()
            for t in workers:
                t.join()
        if watchdog is not None:
            self._watchdog_stop.set()
            watchdog.join()
        with self._lock:
            if self._pump is pump:
                self._pump = None
                self._stage_threads = []
                self._queues = {}
                self._redo = {}
                self._watchdog = None
                self._inflight_buckets = {}
            self._closing = False
            err, self._pump_error = self._pump_error, None
            if self._inflight:
                # restore every non-finalized batch — in admission order,
                # at the FRONT of the queue: no ticket lost or reordered
                self._queue[:0] = [e for b in self._inflight
                                   for e in b.entries]
                self._inflight = []
            self._busy_n = collections.Counter()
            self._busy_since = {}
            self._overlap_since = None
        if err is not None:
            raise RuntimeError(
                "serve() pump failed; in-flight tickets were restored — "
                "drain with run()/step() or serve() again") from err

    def __enter__(self) -> "DesignService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
