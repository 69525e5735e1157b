"""Fault-tolerance runtime: preemption handling, failure simulation,
straggler monitoring, and the auto-restart supervisor loop.

Counterpart of the JAX package's `runtime/fault_tolerance.py`, the
whole file, copied so the port imports nothing of it.

Mechanisms (each exercised by tests):
  * PreemptionGuard — SIGTERM/SIGINT set a flag; the consumer stops at
    the next safe boundary.  The consumer in this package is
    `repro_torch.serve.design_service.DesignService`, which drains its
    in-flight stages and journals unfinished tickets to a WAL
    (`repro_torch.api.artifact_cache.TicketJournal`) for replay by a
    restarted service.  (The reference's trainer, which checkpoints and
    exits with RESTART_EXIT_CODE for its supervisor to relaunch, comes
    to the port in a later slice.)  Usable as a context manager;
    `install()` on an already-installed guard raises instead of
    silently clobbering the saved handlers, and `uninstall()` restores
    them exactly once.  `install()` works only in the main thread.
  * StragglerMonitor — wall-time EMA + deviation per unit of work
    (train steps, layout buckets); units slower than `threshold` x EMA
    are flagged; `stuck(dt)` answers the same question for an
    *in-flight* unit, which is what the design service's shed policy
    polls (re-queue the stuck bucket to a peer worker, first
    completion wins).
  * FailureInjector — deterministic fault schedule for tests: by train
    step (`fail_at_steps`, the legacy trainer shape) or by
    stage-keyed unit index (`fail_at={"layout": [2]}`), with kinds
    `node` (raise SimulatedNodeFailure), `slow` (sleep
    `slow_seconds`), and `preempt` (request preemption on the attached
    guard) — so retry, shed, and journal/replay paths are all
    testable without real signals.
  * run_supervised — in-process restart loop with a capped exponential
    backoff between restarts (injectable `sleep` for tests), so a
    crash-looping worker cannot hot-spin through its restart budget.
    `restart_on` names the exception types that count as a
    restartable crash (the design service's stage workers pass
    `(Exception,)`).
"""
from __future__ import annotations

import dataclasses
import random
import signal
import time
from typing import Callable

RESTART_EXIT_CODE = 42


class SimulatedNodeFailure(RuntimeError):
    pass


def capped_backoff(attempt: int, *, base_s: float, cap_s: float,
                   jitter_frac: float = 0.0,
                   rng: random.Random | None = None) -> float:
    """Delay before retry number `attempt` (1-based): exponential from
    `base_s`, capped at `cap_s`, with up to `jitter_frac` uniform jitter
    added so a fleet of workers retrying the same dead dependency does
    not thunder back in lockstep."""
    if attempt < 1:
        raise ValueError("attempt is 1-based")
    delay = min(cap_s, base_s * (2.0 ** (attempt - 1)))
    if jitter_frac > 0.0:
        delay *= 1.0 + (rng or random).uniform(0.0, jitter_frac)
    return delay


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that request a clean stop.

    `install()`/`uninstall()` pair exactly once (double-install raises —
    it would leak the original handlers); the guard is also a context
    manager.  Tests trigger preemption without a real signal via
    `request()`, which never needs `install()` at all.
    """

    def __init__(self) -> None:
        self._requested = False
        self._prev: dict[int, object] | None = None   # None = not installed

    @property
    def installed(self) -> bool:
        return self._prev is not None

    def install(self) -> "PreemptionGuard":
        if self._prev is not None:
            raise RuntimeError(
                "PreemptionGuard.install() called twice; the second install "
                "would clobber the saved handlers and leak the originals — "
                "uninstall() first (or use one guard per scope)")
        self._prev = {sig: signal.signal(sig, self._handler)
                      for sig in (signal.SIGTERM, signal.SIGINT)}
        return self

    def _handler(self, signum, frame) -> None:  # noqa: ANN001
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def request(self) -> None:   # tests trigger without a real signal
        self._requested = True

    def uninstall(self) -> None:
        """Restore the saved handlers exactly once.  Idempotent: a second
        (or unpaired) `uninstall()` is a no-op rather than re-restoring
        stale handlers over someone else's."""
        prev, self._prev = self._prev, None
        if prev is None:
            return
        for sig, handler in prev.items():
            signal.signal(sig, handler)

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0       # x EMA counts as straggling
    ema_decay: float = 0.9
    ema: float | None = None
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = self.ema is not None and dt > self.threshold * self.ema
        if is_straggler:
            self.events.append((step, dt, self.ema))
        else:
            # stragglers don't poison the EMA
            self.ema = dt if self.ema is None else \
                self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        return is_straggler

    def stuck(self, dt: float) -> bool:
        """Whether an *in-flight* unit already running for `dt` seconds
        counts as straggling (no EMA yet -> never: there is no baseline
        to judge against).  Unlike `observe` this neither records an
        event nor updates the EMA — the shed watchdog polls it."""
        return self.ema is not None and dt > self.threshold * self.ema

    def mitigation_plan(self, n_hosts: int, slow_host: int) -> list[int]:
        """Return a data-shard -> host assignment that drains the slow host
        (its shards round-robin to the others) until it recovers."""
        return [h if h != slow_host else (h + 1) % n_hosts
                for h in range(n_hosts)]


@dataclasses.dataclass
class FailureInjector:
    """Deterministic fault schedule for tests and chaos benchmarks.

    Two addressing modes:

      * by train step (the legacy trainer shape): `fail_at_steps` +
        `kind`, fired from `maybe_fail(step)`;
      * by (stage, unit index): `fail_at` maps a stage name to a
        sequence of unit indices — plain ints fire the injector-level
        `kind`, `(index, kind)` pairs override it per entry.  Fired
        from `fire(stage, unit)`, where `unit` is the caller's
        monotonically increasing per-stage counter (so a retried unit
        gets a *new* index and an injected failure fires exactly once).

    Kinds: `node` raises SimulatedNodeFailure (the retry/isolation
    path), `slow` sleeps `slow_seconds` (the straggler/shed path),
    `preempt` calls `guard.request()` (the journal/replay path —
    `guard` must be attached).
    """

    fail_at_steps: tuple[int, ...] = ()
    kind: str = "node"           # node | slow | preempt
    slow_seconds: float = 0.0
    fail_at: dict = dataclasses.field(default_factory=dict)
    guard: PreemptionGuard | None = None
    fired: list = dataclasses.field(default_factory=list)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps:
            self._fire("train", step, self.kind)

    def fire(self, stage: str, unit: int) -> None:
        for entry in self.fail_at.get(stage, ()):
            index, kind = (entry if isinstance(entry, tuple)
                           else (entry, self.kind))
            if index == unit:
                self._fire(stage, unit, kind)

    def _fire(self, stage: str, unit: int, kind: str) -> None:
        self.fired.append((stage, unit, kind))
        if kind == "node":
            raise SimulatedNodeFailure(
                f"injected {stage} failure at unit {unit}")
        if kind == "slow":
            time.sleep(self.slow_seconds)
        elif kind == "preempt":
            if self.guard is None:
                raise ValueError("FailureInjector kind='preempt' needs an "
                                 "attached PreemptionGuard (guard=...)")
            self.guard.request()
        else:
            raise ValueError(f"unknown failure kind {kind!r} "
                             f"(expected node|slow|preempt)")


def run_supervised(make_and_run: Callable[[], int], *,
                   max_restarts: int = 5,
                   restart_on: tuple[type[BaseException], ...]
                   = (SimulatedNodeFailure,),
                   backoff_s: float = 0.1, backoff_cap_s: float = 30.0,
                   sleep: Callable[[float], None] = time.sleep,
                   on_restart: Callable[[int], None] | None = None) -> int:
    """In-process supervisor: re-invokes the worker function while it
    exits with RESTART_EXIT_CODE or dies with one of the `restart_on`
    exception types (default: SimulatedNodeFailure — the trainer
    contract; stage workers pass `(Exception,)`).

    Restarts are spaced by a capped exponential backoff
    (`capped_backoff(n, base_s=backoff_s, cap_s=backoff_cap_s)`), so a
    worker that crashes instantly cannot burn its whole restart budget
    in milliseconds.  `sleep` is injectable so tests assert the delays
    without waiting them out; `on_restart(n)` (if given) is called
    before each restart — the design service counts these into its
    stats."""
    restarts = 0
    while True:
        try:
            code = make_and_run()
        except restart_on:
            code = RESTART_EXIT_CODE
        if code != RESTART_EXIT_CODE:
            return code
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError("restart budget exhausted")
        if backoff_s > 0.0:
            sleep(capped_backoff(restarts, base_s=backoff_s,
                                 cap_s=backoff_cap_s))
        if on_restart is not None:
            on_restart(restarts)
