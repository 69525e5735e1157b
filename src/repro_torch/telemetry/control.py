"""Feedback control plane: adaptive coalescing + layout-pool autoscaling.

The service exposes two throughput/latency knobs that would otherwise
stay static: the admission pump's `coalesce_window_s` (how long to hold the
oldest queued request hoping more arrive to share its dispatch) and
the layout pool width `layout_workers`.  A fixed window is wrong in
both directions — too wide, and a lone request eats the whole window
as pure latency; too narrow, and a burst fragments into per-request
dispatches that each pay full exploration.  `FeedbackController`
closes the loop from *observed* windowed metrics:

  * **arrival-rate EMA** -> coalescing window.  The window that
    gathers one full batch is `target_batch / rate`; the controller
    tracks an EMA of the arrival rate (counted from the service's
    monotonic submission counter, so missed ticks lose nothing) and
    eases the live window toward that ideal between
    `[min_window_s, max_window_s]`.  Bursty traffic widens the window
    while the burst lasts; an idle or trickling queue narrows it to
    the latency floor.
  * **layout backlog + occupancy -> pool width.**  Sustained backlog
    above `scale_up_backlog` buckets per worker grows the pool by one
    (up to `max_workers`); a drained queue with idle workers shrinks
    it (down to `min_workers`).  Both directions require
    `hysteresis_ticks` *consecutive* agreeing observations, so a
    single bucket burst or momentary idle gap cannot flap the pool.

The controller is deliberately pure and clocked from outside
(`tick(now, ...)`): the service calls it from the admission pump loop
(bounded waits guarantee a tick at least every `tick_interval_s` even
on an idle queue), and tests drive it with synthetic clocks — no
sleeps, no threads of its own.  Every actuating decision is recorded
as a `cat="control"` instant span on the attached recorder AND kept in
`decisions`, so control behaviour is auditable after the fact: the
Gantt shows *why* the window moved next to the batches it affected.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.telemetry.spans import SpanRecorder


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Bounds and cadence of the feedback loop.  Defaults are sized for
    the design-service bench workloads; `target_batch` is filled from
    the service's `max_coalesce` when left `None`."""

    min_window_s: float = 0.01
    max_window_s: float = 0.5
    target_batch: int | None = None
    window_smoothing: float = 0.5     # EMA weight of the OLD window
    rate_decay: float = 0.5           # EMA weight of the old arrival rate
    min_workers: int = 1
    max_workers: int = 1              # == min: autoscaling disabled
    scale_up_backlog: float = 2.0     # queued buckets per worker to grow
    hysteresis_ticks: int = 3
    tick_interval_s: float = 0.05

    def __post_init__(self):
        if not 0 < self.min_window_s <= self.max_window_s:
            raise ValueError("need 0 < min_window_s <= max_window_s")
        if not 1 <= self.min_workers <= self.max_workers:
            raise ValueError("need 1 <= min_workers <= max_workers")
        if not 0.0 <= self.window_smoothing < 1.0:
            raise ValueError("window_smoothing must be in [0, 1)")
        if self.hysteresis_ticks < 1:
            raise ValueError("hysteresis_ticks must be >= 1")


@dataclasses.dataclass(frozen=True)
class ControlDecision:
    """One actuation: the knob values the service should apply now."""

    at_s: float
    window_s: float
    workers: int
    arrival_rate: float               # the EMA the decision was based on
    reason: str


class FeedbackController:
    """Windowed-metrics consumer driving the two admission knobs (see
    module docstring).  One instance per service; not thread-safe by
    itself — the admission pump is its single caller."""

    def __init__(self, config: ControllerConfig | None = None, *,
                 recorder: SpanRecorder | None = None):
        self.config = config or ControllerConfig()
        self.recorder = recorder
        self.arrival_rate = 0.0       # requests/s EMA
        self.decisions: list[ControlDecision] = []
        self._last_t: float | None = None
        self._last_arrivals = 0
        self._up_ticks = 0
        self._down_ticks = 0

    def tick(self, now: float | None = None, *, queue_depth: int,
             arrivals_total: int, layout_backlog: int, inflight_buckets: int,
             layout_workers: int, window_s: float
             ) -> ControlDecision | None:
        """Consume one observation window; returns the decision to apply
        or `None` when nothing should change (first tick, sub-interval
        tick, or knobs already where the policy wants them).

        `arrivals_total` is the service's monotonic submission count —
        deltas are taken here, so a delayed tick still sees every
        arrival.  `layout_backlog` counts buckets waiting in the layout
        queue; `inflight_buckets` the ones running in the pool."""
        cfg = self.config
        if now is None:
            now = time.monotonic()
        if self._last_t is None:
            # Baseline establishes the time origin only: arrivals that
            # raced ahead of the first tick still count in the first
            # observation window (the pump may start ticking after the
            # tenants have already submitted).
            self._last_t = now
            return None
        dt = now - self._last_t
        if dt < cfg.tick_interval_s:
            return None
        arrived = arrivals_total - self._last_arrivals
        self._last_t, self._last_arrivals = now, arrivals_total
        rate = arrived / dt
        self.arrival_rate = (cfg.rate_decay * self.arrival_rate
                             + (1.0 - cfg.rate_decay) * rate)

        # -- coalescing window: ease toward target_batch / rate --------
        target = max(1, cfg.target_batch or 1)
        if self.arrival_rate > 1e-9:
            desired = target / self.arrival_rate
        else:
            desired = cfg.min_window_s   # idle: latency floor
        desired = min(max(desired, cfg.min_window_s), cfg.max_window_s)
        new_window = (cfg.window_smoothing * window_s
                      + (1.0 - cfg.window_smoothing) * desired)
        new_window = min(max(new_window, cfg.min_window_s),
                         cfg.max_window_s)

        # -- pool width: backlog pressure with hysteresis --------------
        new_workers = layout_workers
        reasons = []
        busy_frac = inflight_buckets / max(layout_workers, 1)
        if layout_backlog >= cfg.scale_up_backlog * layout_workers \
                and layout_workers < cfg.max_workers:
            self._up_ticks += 1
            self._down_ticks = 0
            if self._up_ticks >= cfg.hysteresis_ticks:
                new_workers = layout_workers + 1
                self._up_ticks = 0
                reasons.append(
                    f"backlog {layout_backlog} >= "
                    f"{cfg.scale_up_backlog:g}/worker: grow pool")
        elif layout_backlog == 0 and busy_frac == 0.0 \
                and layout_workers > cfg.min_workers:
            self._down_ticks += 1
            self._up_ticks = 0
            if self._down_ticks >= cfg.hysteresis_ticks:
                new_workers = layout_workers - 1
                self._down_ticks = 0
                reasons.append("pool idle: shrink")
        else:
            self._up_ticks = self._down_ticks = 0

        window_moved = abs(new_window - window_s) > 1e-3 * window_s
        if not window_moved and new_workers == layout_workers:
            return None
        if window_moved:
            reasons.insert(0, f"rate {self.arrival_rate:.2f}/s -> "
                              f"window {new_window:.3f}s")
        decision = ControlDecision(
            at_s=now, window_s=new_window if window_moved else window_s,
            workers=new_workers, arrival_rate=self.arrival_rate,
            reason="; ".join(reasons))
        self.decisions.append(decision)
        if self.recorder is not None:
            self.recorder.instant(
                "control", cat="control", at=now,
                window_s=decision.window_s, workers=decision.workers,
                arrival_rate=round(self.arrival_rate, 4),
                queue_depth=queue_depth, layout_backlog=layout_backlog,
                reason=decision.reason)
        return decision
