"""The port's fault-tolerant service on the CPU: per-bucket retry and
isolation in the layout pool, error artifacts for failed batch stages,
supervised worker restarts, preemption -> journal -> replay, straggler
shedding, and the `repro_torch.runtime.fault_tolerance` primitives they
are built on — the pure ones held exactly to the reference's on the same
inputs.  Every fault is injected deterministically (`FailureInjector`
schedules, monkeypatched stage functions, injectable `sleep`)."""
import dataclasses
import random
import signal
import time

import pytest

from repro.runtime import fault_tolerance as rft
from repro_torch.api import (DesignRequest, DesignSession, Requirements,
                             TicketJournal)
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 PreemptionGuard,
                                                 SimulatedNodeFailure,
                                                 StragglerMonitor,
                                                 capped_backoff,
                                                 run_supervised)
from repro_torch.serve.design_service import DesignService, PendingTicket
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

# threaded pipeline tests deadlock rather than fail when broken
pytestmark = pytest.mark.timeout(300)

POP, GENS = 48, 10
# one spec of the 4096 front at seed 0 (one layout bucket)
LAID = Requirements(min_snr_db=25.0, min_tops=0.3)
# at most three specs of the 4096 front, in buckets LAID's spec avoids
REQS = Requirements(min_snr_db=17.0, min_tops=0.4)


def _request(array_size=4096, seed=0, **kw):
    kw.setdefault("pop_size", POP)
    kw.setdefault("generations", GENS)
    kw.setdefault("layout", False)
    return DesignRequest(array_size=array_size, seed=seed, **kw)


def _fast_svc(**kw):
    """A CPU service with sub-millisecond retry backoff and a short
    coalescing window."""
    kw.setdefault("coalesce_window_s", 0.02)
    kw.setdefault("retry_backoff_s", 0.001)
    kw.setdefault("retry_backoff_cap_s", 0.002)
    if "session" not in kw:
        kw.setdefault("device", "cpu")
    return DesignService(**kw)


@pytest.fixture(scope="module")
def laid_reference():
    """The sequential artifact of the one-bucket laid-out request."""
    req = _request(requirements=LAID, layout=True)
    return req, DesignSession(device="cpu").run_many(
        [req], strict=False)[req]


# -- primitives, held to the reference ----------------------------------

class TestCappedBackoff:
    def test_exponential_then_capped(self):
        delays = [capped_backoff(n, base_s=0.1, cap_s=0.5)
                  for n in (1, 2, 3, 4, 5)]
        assert delays == [0.1, 0.2, 0.4, 0.5, 0.5]

    @pytest.mark.parametrize("jitter", [0.0, 0.1, 0.25])
    def test_equals_reference_on_seeded_rng(self, jitter):
        mine, ref = random.Random(7), random.Random(7)
        for attempt in range(1, 12):
            for base, cap in ((0.05, 2.0), (0.1, 0.3), (1.0, 30.0)):
                assert capped_backoff(
                    attempt, base_s=base, cap_s=cap, jitter_frac=jitter,
                    rng=mine) == rft.capped_backoff(
                        attempt, base_s=base, cap_s=cap,
                        jitter_frac=jitter, rng=ref)

    def test_jitter_bounded_and_attempt_validated(self):
        rng = random.Random(7)
        for _ in range(50):
            d = capped_backoff(3, base_s=0.1, cap_s=10.0,
                               jitter_frac=0.25, rng=rng)
            assert 0.4 <= d <= 0.4 * 1.25
        with pytest.raises(ValueError, match="1-based"):
            capped_backoff(0, base_s=0.1, cap_s=1.0)


class TestStragglerMonitor:
    def test_equals_reference_on_the_same_stream(self):
        rng = random.Random(3)
        times = [rng.choice([0.1, 0.12, 0.5, 0.09, 1.3, 0.11])
                 for _ in range(200)]
        mine = StragglerMonitor(threshold=2.0, ema_decay=0.8)
        ref = rft.StragglerMonitor(threshold=2.0, ema_decay=0.8)
        for i, dt in enumerate(times):
            assert mine.observe(i, dt) == ref.observe(i, dt)
            assert mine.ema == ref.ema
            for probe in (0.05, 0.3, 2.0):
                assert mine.stuck(probe) == ref.stuck(probe)
        assert mine.events == ref.events and mine.events
        assert mine.mitigation_plan(4, 2) == ref.mitigation_plan(4, 2)

    def test_no_baseline_never_stuck(self):
        assert not StragglerMonitor().stuck(1e9)


class TestPreemptionGuard:
    def test_double_install_raises_and_uninstall_restores_once(self):
        before = signal.getsignal(signal.SIGTERM)
        guard = PreemptionGuard()
        guard.install()
        assert guard.installed
        with pytest.raises(RuntimeError, match="install\\(\\) called twice"):
            guard.install()
        guard.uninstall()
        assert not guard.installed
        assert signal.getsignal(signal.SIGTERM) is before
        other = PreemptionGuard().install()
        guard.uninstall()   # no-op, NOT a restore of `before`
        assert signal.getsignal(signal.SIGTERM) == other._handler
        other.uninstall()
        assert signal.getsignal(signal.SIGTERM) is before

    def test_context_manager_and_request_without_install(self):
        with PreemptionGuard() as guard:
            assert guard.installed and not guard.preempted
            guard.request()
            assert guard.preempted
        assert not guard.installed
        g = PreemptionGuard()
        g.request()
        assert g.preempted and not g.installed


class TestRunSupervised:
    def test_backoff_spacing_between_restarts(self):
        slept, calls = [], []

        def crashy():
            calls.append(1)
            if len(calls) < 4:
                raise SimulatedNodeFailure("boom")
            return 0

        assert run_supervised(crashy, max_restarts=5, backoff_s=0.1,
                              backoff_cap_s=0.25, sleep=slept.append) == 0
        assert len(calls) == 4 and slept == [0.1, 0.2, 0.25]

    def test_budget_exhausted_raises(self):
        slept = []

        def always():
            raise SimulatedNodeFailure("boom")

        with pytest.raises(RuntimeError, match="restart budget exhausted"):
            run_supervised(always, max_restarts=2, backoff_s=0.05,
                           sleep=slept.append)
        assert len(slept) == 2

    def test_restart_on_and_callback(self):
        with pytest.raises(ValueError):
            run_supervised(lambda: (_ for _ in ()).throw(ValueError("x")),
                           backoff_s=0.0)
        seen, calls = [], []

        def twice():
            calls.append(1)
            if len(calls) < 3:
                raise ValueError("restartable here")
            return 0

        assert run_supervised(twice, restart_on=(Exception,), backoff_s=0.0,
                              on_restart=seen.append) == 0
        assert seen == [1, 2]
        assert ft.RESTART_EXIT_CODE == rft.RESTART_EXIT_CODE


class TestFailureInjector:
    def test_stage_schedule_fires_once_per_unit(self):
        inj = FailureInjector(fail_at={"layout": [2]})
        inj.fire("layout", 0)
        inj.fire("layout", 1)
        with pytest.raises(SimulatedNodeFailure, match="layout .* unit 2"):
            inj.fire("layout", 2)
        inj.fire("layout", 3)
        inj.fire("explore", 2)
        assert inj.fired == [("layout", 2, "node")]

    def test_per_entry_kind_override_and_preempt(self):
        guard = PreemptionGuard()
        inj = FailureInjector(fail_at={"admit": [(1, "preempt")],
                                       "layout": [0]}, guard=guard)
        inj.fire("admit", 0)
        assert not guard.preempted
        inj.fire("admit", 1)
        assert guard.preempted
        with pytest.raises(SimulatedNodeFailure):
            inj.fire("layout", 0)

    def test_bad_kinds_and_slow(self, monkeypatch):
        with pytest.raises(ValueError, match="PreemptionGuard"):
            FailureInjector(fail_at={"layout": [(0, "preempt")]}).fire(
                "layout", 0)
        with pytest.raises(ValueError, match="unknown failure kind"):
            FailureInjector(fail_at={"layout": [(0, "meteor")]}).fire(
                "layout", 0)
        slept = []
        monkeypatch.setattr(ft.time, "sleep", slept.append)
        FailureInjector(kind="slow", slow_seconds=3.0,
                        fail_at={"layout": [0]}).fire("layout", 0)
        assert slept == [3.0]
        inj = FailureInjector(fail_at_steps=(5,))
        inj.maybe_fail(4)
        with pytest.raises(SimulatedNodeFailure):
            inj.maybe_fail(5)


# -- per-bucket retry and isolation ---------------------------------------

class TestBucketIsolation:
    def test_killed_bucket_retries_then_succeeds(self, laid_reference):
        req, ref = laid_reference
        inj = FailureInjector(fail_at={"layout": [0]})
        svc = _fast_svc(injector=inj, max_retries=2)
        with svc.serve():
            art = svc.collect(svc.submit(req), timeout=120)
        assert art.ok and art.summary() == ref.summary()
        assert art.provenance.retried_buckets == 1
        assert art.provenance.attempts == 2
        stats = svc.stats()
        assert stats["bucket_retries"] == 1
        assert stats["bucket_failures"] == 0
        assert stats["layout_dispatches"] == 1   # the fault fires first
        assert inj.fired == [("layout", 0, "node")]

    def test_exhausted_bucket_isolates_only_touching_tickets(self):
        # two coalesced tenants with disjoint bucket sets; the first
        # layout unit (tenant A's only bucket) dies with no retry budget
        inj = FailureInjector(fail_at={"layout": [0]})
        svc = _fast_svc(max_coalesce=2, coalesce_window_s=0.3,
                        injector=inj, max_retries=0)
        ra = _request(seed=0, requirements=LAID, layout=True)
        rb = _request(seed=1, requirements=REQS, layout=True)
        ref = DesignSession(device="cpu").run_many([ra, rb], strict=False)
        with svc.serve():
            ta, tb = svc.submit(ra), svc.submit(rb)
            aa = svc.collect(ta, timeout=120)
            ab = svc.collect(tb, timeout=120)
        assert not aa.ok
        assert "layout bucket" in aa.error and "failed" in aa.error
        assert aa.pareto.specs and aa.layout_rows is None
        assert ab.ok and ab.summary() == ref[rb].summary()
        stats = svc.stats()
        assert stats["bucket_failures"] == 1
        assert stats["bucket_retries"] == 0
        assert stats["service_batches"] == 1   # one batch, two fates

    @pytest.mark.parametrize("stage", ["explore_stage", "distill_stage",
                                       "finalize_stage"])
    def test_batch_stage_failure_yields_error_artifacts(self, stage,
                                                        monkeypatch):
        svc = _fast_svc(max_retries=1)
        calls = []
        real = getattr(svc.session, stage)

        def boom(*a, **kw):
            calls.append(1)
            raise RuntimeError(f"injected {stage} failure")

        monkeypatch.setattr(svc.session, stage, boom)
        with svc.serve():
            arts = [svc.collect(svc.submit(_request(seed=sd)), timeout=120)
                    for sd in (0,)]
            for a in arts:
                assert not a.ok
                assert f"injected {stage} failure" in a.error
                assert "failed after 2 attempt(s)" in a.error
                assert a.provenance.served_from == "error"
            assert len(calls) == 2            # initial + one retry
            # the pipeline survived: the next batch serves fine
            monkeypatch.setattr(svc.session, stage, real)
            assert svc.collect(svc.submit(_request(seed=1)),
                               timeout=120).ok
        name = stage.split("_")[0]
        stats = svc.stats()
        assert stats[f"{name}_stage_retries"] == 1
        assert stats[f"{name}_stage_failures"] == 1


# -- supervised stage workers ---------------------------------------------

class TestSupervisedWorkers:
    def test_worker_crash_restarts_in_process_and_unit_survives(self):
        svc = _fast_svc()
        real = svc._process_explore
        crashes = []

        def flaky(batch):
            if not crashes:
                crashes.append(1)
                raise RuntimeError("worker loop crash")
            real(batch)

        svc._process_explore = flaky
        with svc.serve():
            art = svc.collect(svc.submit(_request()), timeout=120)
        assert art.ok    # the in-hand batch was re-queued, not lost
        assert svc.stats()["stage_worker_restarts"] == 1

    def test_restart_budget_exhaustion_is_terminal_and_restores(self):
        svc = _fast_svc(worker_restarts=1)

        def always(batch):
            raise RuntimeError("hopeless worker")

        svc._process_explore = always
        svc.serve()
        ticket = svc.submit(_request())
        with pytest.raises(RuntimeError, match="pump failed"):
            svc.collect(ticket, timeout=120)
        with pytest.raises(RuntimeError, match="restored"):
            svc.close()
        assert svc.stats()["stage_worker_restarts"] == 1
        assert svc.poll(ticket) is None
        assert svc.run()[ticket].ok


# -- preemption: drain, journal, replay -----------------------------------

def _drain_pump(svc, timeout=120.0):
    deadline = time.monotonic() + timeout
    while svc._pump is not None and svc._pump.is_alive():
        assert time.monotonic() < deadline, "preempted pump never exited"
        time.sleep(0.02)


class TestPreemptionReplay:
    def test_preempt_journals_then_fresh_service_replays(self, tmp_path):
        reqs = [_request(seed=sd) for sd in range(4)]
        ref = DesignSession(device="cpu").run_many(reqs, strict=False)
        guard = PreemptionGuard()
        svc = _fast_svc(session=DesignSession(artifact_cache=tmp_path,
                                              device="cpu"),
                        max_coalesce=1, pipeline_depth=1, guard=guard)
        assert svc.journal.path.parent == svc.session.artifact_cache.root
        svc.serve()
        tickets = [svc.submit(r) for r in reqs]
        guard.request()              # simulated SIGTERM
        _drain_pump(svc)
        svc.close()
        drained, journaled = {}, []
        for t, r in zip(tickets, reqs):
            try:
                art = svc.poll(t)
            except PendingTicket:
                journaled.append((t, r))
                continue
            assert art is not None, "drain finished with an unset ticket"
            drained[r] = art
        stats = svc.stats()
        assert stats["preemptions"] == 1 and stats["preempted"]
        assert stats["journaled_tickets"] == len(journaled) > 0
        assert [r.seed for r in svc.journal.replay()] == \
            [r.seed for _, r in journaled]   # admission order preserved
        with pytest.raises(RuntimeError, match="preempted"):
            svc.submit(_request(seed=99))
        # a fresh service over the same cache root replays the journal
        svc2 = _fast_svc(session=DesignSession(artifact_cache=tmp_path,
                                               device="cpu"),
                         max_coalesce=1)
        svc2.serve()
        replayed = svc2.stats()["replayed_tickets"]
        assert replayed == len(journaled)
        assert len(svc2.journal) == 0    # cleared once resubmitted
        arts2 = [svc2.collect(t, timeout=120) for t in range(replayed)]
        svc2.close()
        for (_, r), art in zip(journaled, arts2):
            assert art.provenance.served_from == "journal_replay"
            assert art.summary() == ref[r].summary()
        for r, art in drained.items():
            assert art.summary() == ref[r].summary()
        tiers = {s["labels"]["tier"]: s["value"] for s in
                 svc2.metrics()["metrics"]["design_tickets_served_total"]}
        assert tiers["journal_replay"] == replayed

    def test_injector_preempt_kind_drives_the_same_path(self, tmp_path):
        guard = PreemptionGuard()
        inj = FailureInjector(fail_at={"admit": [(1, "preempt")]},
                              guard=guard)
        svc = _fast_svc(max_coalesce=1, guard=guard, injector=inj,
                        journal=tmp_path / "journal.jsonl")
        svc.serve()
        tickets = [svc.submit(_request(seed=sd)) for sd in range(3)]
        _drain_pump(svc)
        svc.close()
        assert guard.preempted
        assert ("admit", 1, "preempt") in inj.fired
        resolved, unresolved = [], []
        for t in tickets:
            try:
                (resolved if svc.poll(t) is not None
                 else unresolved).append(t)
            except PendingTicket:
                unresolved.append(t)
        journaled = {r.sha() for r in svc.journal.replay()}
        for t in unresolved:
            assert _request(seed=t).sha() in journaled
        assert unresolved and resolved

    def test_serve_refused_with_already_preempted_guard(self):
        guard = PreemptionGuard()
        guard.request()
        with pytest.raises(RuntimeError, match="fresh guard"):
            _fast_svc(guard=guard).serve()

    def test_explicit_replay_journal_for_sync_drains(self, tmp_path):
        j = TicketJournal(tmp_path / "journal.jsonl")
        reqs = [_request(seed=sd) for sd in (5, 6)]
        j.write(reqs)
        svc = _fast_svc(journal=j)
        tickets = svc.replay_journal()
        assert len(tickets) == 2 and len(j) == 0
        done = svc.run()
        for t, r in zip(tickets, reqs):
            assert done[t].request == r
            assert done[t].provenance.served_from == "journal_replay"


# -- straggler shedding in the layout pool ---------------------------------

class TestStragglerShed:
    def test_stuck_bucket_shed_to_peer_first_completion_wins(
            self, laid_reference):
        # the first layout dispatch is held by a 4 s slow fault, far past
        # threshold x EMA (0.6 s); the watchdog re-queues it, the peer
        # completes it, and the stuck incarnation is cancelled-on-observe
        req, ref = laid_reference
        mon = StragglerMonitor(threshold=2.0, ema=0.3)
        inj = FailureInjector(slow_seconds=4.0,
                              fail_at={"layout": [(0, "slow")]})
        svc = _fast_svc(layout_workers=2, straggler=mon, injector=inj)
        with svc.serve():
            t0 = time.monotonic()
            art = svc.collect(svc.submit(req), timeout=120)
            waited = time.monotonic() - t0
            live = svc.stats()
        assert art.ok and art.summary() == ref.summary()
        assert art.provenance.shed_buckets == 1
        assert live["shed_buckets"] >= 1
        assert any(ev[0] == "shed" for ev in mon.events)
        assert waited < 4.0   # rescued, not merely waited out
        stats = svc.stats()   # post-close: the loser was observed
        assert stats["shed_losses"] + stats["bucket_cancellations"] >= 1

    def test_single_worker_pool_never_sheds(self, laid_reference):
        req, ref = laid_reference
        mon = StragglerMonitor(threshold=2.0, ema=0.001)
        svc = _fast_svc(layout_workers=1, straggler=mon)
        with svc.serve():
            art = svc.collect(svc.submit(req), timeout=120)
        assert art.ok and art.summary() == ref.summary()
        assert svc.stats()["shed_buckets"] == 0
        assert not any(ev[0] == "shed" for ev in mon.events)


def test_fault_primitives_fields_match_reference():
    for cls in ("StragglerMonitor", "FailureInjector"):
        mine = [f.name for f in dataclasses.fields(getattr(ft, cls))]
        ref = [f.name for f in dataclasses.fields(getattr(rft, cls))]
        assert mine == ref, cls
