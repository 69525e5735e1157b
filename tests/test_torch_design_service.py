"""The port's multi-tenant `DesignService` on the CPU: the pipelined
service is ticket-for-ticket equal to the sequential `run_many` (on a
mixed batch of laid-out, front-only and poison tenants), its layout rows
equal the reference flow's for the same specs, concurrent submits, the
K-wide layout pool, the ticket lifecycle, drain on close, the `stats()`
snapshot contract, the reference's stats keys and metric names, and
exact launch counts from many threads."""
import dataclasses
import sys
import threading
import time

import pytest
import torch

from repro.eda import batched_flow as rflow
from repro.core.acim_spec import MacroSpec as RSpec
from repro.serve import design_service as rservice
from repro_torch.api import (DesignArtifact, DesignRequest, DesignSession,
                             Requirements, default_session)
from repro_torch.kernels import LAUNCHES, count_launch
from repro_torch.serve.design_service import (DesignService, PendingTicket,
                                              UnknownTicket)
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

# every test here runs threads; a pipeline bug deadlocks rather than
# fails, so each carries a hard deadline (the conftest watchdog)
pytestmark = pytest.mark.timeout(300)

POP, GENS = 48, 10
# one spec of the 4096 front at seed 0, two at seed 1: quick plain routing
LAID = Requirements(min_snr_db=25.0, min_tops=0.3)
# at most three specs of the 4096 front, in buckets LAID's spec avoids
REQS = Requirements(min_snr_db=17.0, min_tops=0.4)
POISON = Requirements(min_tops=1e9)


def _request(array_size=4096, seed=0, **kw):
    kw.setdefault("pop_size", POP)
    kw.setdefault("generations", GENS)
    kw.setdefault("layout", False)
    return DesignRequest(array_size=array_size, seed=seed, **kw)


def _svc(**kw):
    kw.setdefault("device", "cpu")
    return DesignService(**kw)


MIXED = [_request(seed=0, requirements=LAID, layout=True),
         _request(seed=1, requirements=LAID, layout=True),
         _request(array_size=16384),
         _request(seed=2, requirements=POISON, layout=True)]


@pytest.fixture(scope="module")
def sequential():
    return DesignSession(device="cpu").run_many(MIXED, strict=False)


@pytest.fixture(scope="module")
def pipelined():
    svc = _svc(max_coalesce=4, coalesce_window_s=0.25, layout_workers=2)
    with svc.serve():
        tickets = [svc.submit(r) for r in MIXED]
        arts = [svc.collect(t, timeout=120) for t in tickets]
    return svc, arts


# -- pipelined == sequential ---------------------------------------------

class TestPipelinedEquality:
    def test_pipelined_equals_sequential_stages(self, sequential,
                                                pipelined):
        svc, arts = pipelined
        for r, a in zip(MIXED, arts):
            assert a.request == r
            assert a.summary() == sequential[r].summary()
            assert a.ok == sequential[r].ok
            assert a.error == sequential[r].error
            assert a.provenance.pipelined
        assert not arts[3].ok
        assert "removed every Pareto point" in arts[3].error
        assert arts[2].layout_rows is None and arts[2].ok
        stats = svc.stats()
        assert stats["service_batches"] == 1
        assert stats["service_batch_requests"] == 4
        assert stats["explorer_dispatches"] == 1
        assert arts[0].provenance.coalesced == 4

    def test_rows_equal_reference_flow(self, pipelined):
        """The laid-out tenants' rows equal the reference's batched flow
        on the same specs."""
        _, arts = pipelined
        for a in arts[:2]:
            specs = [RSpec(*s.as_tuple()) for s in a.pareto.specs]
            want = rflow.generate_layouts(
                specs, engine="concurrent").metrics_rows()
            assert list(a.layout_rows) == want
            assert a.provenance.route_engine == "scan"
            assert a.provenance.worker_id.startswith("layout-")
            assert a.provenance.attempts == a.provenance.layout_dispatches

    def test_concurrent_submits_multi_batch(self):
        # max_coalesce=2 forces several batches in flight; every tenant
        # gets its own request's artifact back
        svc = _svc(max_coalesce=2, coalesce_window_s=0.05)
        seeds = list(range(5))
        results, errors = {}, []

        def tenant(sd):
            try:
                t = svc.submit(_request(seed=sd, requirements=REQS))
                results[sd] = svc.collect(t, timeout=120)
            except Exception as e:   # surfaced below
                errors.append(e)

        with svc.serve():
            threads = [threading.Thread(target=tenant, args=(sd,))
                       for sd in seeds]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        assert not errors
        assert sorted(results) == seeds
        assert {results[sd].request.seed for sd in seeds} == set(seeds)
        seq = DesignSession(device="cpu").run_many(
            [_request(seed=sd, requirements=REQS) for sd in seeds],
            strict=False)
        for sd in seeds:
            assert results[sd].summary() == \
                seq[results[sd].request].summary()
        assert svc.stats()["service_batches"] >= 3
        assert len(svc) == 0 and not svc.done   # collected == popped

    def test_layout_pool_k_wide(self, sequential):
        """Two tenants with disjoint buckets through a 4-wide pool: every
        bucket a unit of its own, rows equal to the sequential run."""
        reqs = [MIXED[0], _request(seed=1, requirements=REQS, layout=True)]
        seq = DesignSession(device="cpu").run_many(reqs, strict=False)
        svc = _svc(max_coalesce=2, coalesce_window_s=0.3, layout_workers=4)
        with svc.serve():
            tickets = [svc.submit(r) for r in reqs]
            arts = [svc.collect(t, timeout=120) for t in tickets]
            assert sum(t.name.startswith("design-service-layout")
                       for t in svc._stage_threads) == 4
        for r, a in zip(reqs, arts):
            assert a.ok and a.summary() == seq[r].summary()
            assert a.provenance.worker_id.startswith("layout-")
        stats = svc.stats()
        assert stats["layout_workers"] == 4
        assert stats["layout_dispatches"] == sum(
            a.provenance.layout_dispatches for a in arts) >= 3
        assert arts[0].summary() == sequential[MIXED[0]].summary()

    def test_multi_batch_overlap_and_waits(self):
        svc = _svc(max_coalesce=1)
        with svc.serve():
            tickets = [svc.submit(_request(seed=sd, requirements=LAID,
                                           layout=True))
                       for sd in (0, 1, 2)]
            arts = [svc.collect(t, timeout=120) for t in tickets]
            stats = svc.stats()
        assert stats["service_batches"] == 3
        busy = stats["stage_busy_s"]
        assert busy["explore"] > 0 and busy["layout"] > 0
        assert busy["finalize"] > 0
        assert 0 <= stats["pipeline_overlap_fraction"] <= 1.0
        for a in arts:
            assert a.ok and a.provenance.pipelined
            assert a.provenance.layout_wait_s >= 0.0
        # later batches waited on the explore queue behind earlier ones
        assert arts[-1].provenance.explore_wait_s > 0.0

    def test_sequential_driver_reports_not_pipelined(self, sequential):
        art = sequential[MIXED[0]]
        assert not art.provenance.pipelined
        assert art.provenance.explore_wait_s == 0.0
        assert art.provenance.layout_wait_s == 0.0


# -- lifecycle ------------------------------------------------------------

class TestLifecycle:
    def test_mid_pipeline_close_drains_all_tickets(self):
        svc = _svc(max_coalesce=1)
        svc.serve()
        tickets = [svc.submit(_request(seed=sd)) for sd in range(4)]
        svc.close()
        for t in tickets:
            art = svc.poll(t)
            assert art is not None and art.ok
        assert len(svc) == 0

    def test_front_only_requests_flow_through(self):
        svc = _svc(coalesce_window_s=0.05)
        with svc.serve():
            art = svc.collect(svc.submit(_request()), timeout=120)
        assert art.ok and art.layout_rows is None
        assert art.provenance.layout_dispatches == 0
        assert art.provenance.pipelined

    def test_artifact_cache_hits_flow_through_pipeline(self, tmp_path):
        req = _request(requirements=REQS)
        DesignSession(artifact_cache=tmp_path, device="cpu").run(req)
        svc = DesignService(DesignSession(artifact_cache=tmp_path,
                                          device="cpu"))
        assert svc.journal.path.parent == tmp_path
        with svc.serve():
            art = svc.collect(svc.submit(req), timeout=120)
        assert art.provenance.served_from == "artifact_cache"
        assert art.provenance.explorer_dispatches == 0
        assert art.provenance.pipelined

    def test_serial_pump_still_available(self):
        svc = _svc(coalesce_window_s=0.05)
        with svc.serve(pipelined=False):
            assert svc.serve(pipelined=False) is svc   # same mode: idempotent
            with pytest.raises(RuntimeError, match="close\\(\\) first"):
                svc.serve(pipelined=True)
            art = svc.collect(svc.submit(_request()), timeout=120)
        assert art.ok and not art.provenance.pipelined
        stats = svc.stats()
        assert not stats["pipelined"]
        assert stats["pipeline_overlap_s"] == 0.0

    def test_serve_idempotent_and_close_reusable(self):
        svc = _svc(coalesce_window_s=0.05)
        assert svc.serve() is svc.serve()
        svc.close()
        svc.close()   # idempotent
        t = svc.submit(_request())
        assert svc.run()[t].ok
        with svc.serve():
            t2 = svc.submit(_request(seed=1))
            assert svc.collect(t2, timeout=120).ok

    def test_run_and_step_refused_while_pump_active(self):
        svc = _svc()
        with svc.serve():
            with pytest.raises(RuntimeError, match="serve\\(\\) pump"):
                svc.run()
            with pytest.raises(RuntimeError, match="serve\\(\\) pump"):
                svc.step()

    def test_submit_and_serve_refused_while_closing(self):
        svc = _svc()
        svc._closing = True   # the mid-close window
        with pytest.raises(RuntimeError, match="closing"):
            svc.submit(_request())
        with pytest.raises(RuntimeError, match="close\\(\\) is in progress"):
            svc.serve()
        svc._closing = False
        svc._sync_dispatchers = 1   # a run()/step() drain in flight
        with pytest.raises(RuntimeError, match="run\\(\\)/step\\(\\) drain"):
            svc.serve()

    def test_window_deadline_and_full_batch(self):
        svc = _svc(max_coalesce=64, coalesce_window_s=0.2)
        with svc.serve():
            assert svc.collect(svc.submit(_request()), timeout=120).ok
        assert svc.stats()["service_batches"] == 1
        svc = _svc(max_coalesce=2, coalesce_window_s=3600.0)
        with svc.serve():
            tickets = [svc.submit(_request(seed=sd)) for sd in (0, 1)]
            assert all(svc.collect(t, timeout=120).ok for t in tickets)
        assert svc.stats()["service_batches"] == 1

    def test_knob_validation(self):
        for kw, msg in (({"max_coalesce": 0}, "max_coalesce"),
                        ({"coalesce_window_s": -1}, "coalesce_window_s"),
                        ({"pipeline_depth": 0}, "pipeline_depth"),
                        ({"layout_workers": 0}, "layout_workers"),
                        ({"max_retries": -1}, "max_retries")):
            with pytest.raises(ValueError, match=msg):
                _svc(**kw)


class TestTickets:
    def test_unknown_vs_pending_vs_collected(self):
        svc = _svc()
        with pytest.raises(UnknownTicket, match="never issued"):
            svc.poll(0)
        ticket = svc.submit(_request())
        assert svc.poll(ticket) is None   # pending, not an error
        with pytest.raises(PendingTicket, match="still pending"):
            svc.collect(ticket)           # no pump, no timeout
        svc.run()
        assert svc.collect(ticket).ok
        with pytest.raises(UnknownTicket, match="already collected"):
            svc.collect(ticket)
        with pytest.raises(UnknownTicket, match="never issued"):
            svc.collect(ticket + 1)

    def test_collect_timeout_raises_pending(self):
        svc = _svc()
        ticket = svc.submit(_request())
        t0 = time.monotonic()
        with pytest.raises(PendingTicket, match="after 0.2"):
            svc.collect(ticket, timeout=0.2)
        assert 0.1 < time.monotonic() - t0 < 10.0

    def test_done_bounded_by_pop_on_collect(self):
        svc = _svc()
        tickets = [svc.submit(_request(seed=sd)) for sd in (0, 1)]
        svc.run()
        assert len(svc.done) == 2
        kept = svc.collect(tickets[0], keep_done=True)
        assert svc.collect(tickets[0]) is kept
        svc.collect(tickets[1])
        assert not svc.done

    def test_step_restores_batch_in_order(self, monkeypatch):
        svc = _svc(max_coalesce=2)
        tickets = [svc.submit(_request(seed=sd)) for sd in range(3)]

        def boom(*a, **kw):
            raise RuntimeError("injected dispatch failure")

        monkeypatch.setattr(svc.session, "run_many", boom)
        with pytest.raises(RuntimeError, match="injected"):
            svc.step()
        assert [t for t, _, _ in svc._queue] == tickets
        monkeypatch.undo()
        done = svc.run()
        assert [done[t].request.seed for t in tickets] == [0, 1, 2]


# -- accounting -----------------------------------------------------------

class TestStatsSnapshot:
    def test_snapshot_is_isolated_and_gauged(self):
        svc = _svc()
        t0 = svc.submit(_request(seed=0))
        svc.submit(_request(seed=1))
        before = svc.stats()
        assert before["queue_depth"] == 2
        assert before["done_count"] == 0
        assert not before["pump_alive"]
        before["explorer_dispatches"] = 10 ** 9
        before["stage_busy_s"]["explore"] = -1.0
        svc.run()
        after = svc.stats()
        assert after["queue_depth"] == 0
        assert after["done_count"] == 2
        assert after["explorer_dispatches"] < 10 ** 9
        assert after["stage_busy_s"]["explore"] >= 0.0
        assert set(after["stage_queue_depth"]) == {"explore", "distill",
                                                   "layout", "finalize"}
        svc.collect(t0)
        assert svc.stats()["done_count"] == 1

    def test_inflight_gauge_returns_to_zero(self):
        svc = _svc(coalesce_window_s=0.02)
        with svc.serve():
            svc.collect(svc.submit(_request()), timeout=120)
        stats = svc.stats()
        assert stats["inflight_batches"] == 0
        assert all(d == 0 for d in stats["stage_queue_depth"].values())

    def test_stats_keys_and_metric_names_equal_reference(self):
        """Built without running a request: the same stats keys, the
        same metric series (name, labels, type) and the same help text
        as the reference's service."""
        ref, mine = rservice.DesignService(), _svc()
        assert set(ref.stats()) == set(mine.stats())

        def series(snap):
            return {(name, tuple(sorted(s["labels"].items())), s["type"],
                     s["help"])
                    for name, ss in snap["metrics"].items() for s in ss}

        assert series(mine.metrics()) == series(ref.metrics())
        assert "design_mesh_dispatches_total" in mine.metrics()["metrics"]

    def test_stats_keys_after_a_run(self, pipelined):
        """A pipelined run bumps the session counters the reference's
        session bumps on the same path (no mesh)."""
        svc, _ = pipelined
        assert {"explorer_dispatches", "run_cell_traces",
                "layout_dispatches", "program_cache_misses",
                "requests_served", "service_batches",
                "service_batch_requests", "grid_sig_hits"} <= \
            set(svc.stats())

    def test_waits_and_coalescing_in_provenance(self, tmp_path):
        svc = _svc(coalesce_window_s=0.2)
        with svc.serve():
            ta = svc.submit(_request(seed=0))
            tb = svc.submit(_request(seed=1))
            a = svc.collect(ta, timeout=120)
            b = svc.collect(tb, timeout=120)
        assert a.provenance.coalesced == b.provenance.coalesced == 2
        assert a.provenance.explore_wait_s == b.provenance.explore_wait_s
        path = tmp_path / "artifact.json"
        a.to_json(path)
        assert DesignArtifact.from_json(path).provenance == a.provenance


# -- devices and thread-safe launch counts --------------------------------

def test_service_and_cached_session_run_on_cuda_by_default(monkeypatch,
                                                           tmp_path):
    from repro_torch import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(api, "_DEFAULT_SESSION", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        DesignService()
    with pytest.raises(RuntimeError, match="CUDA"):
        DesignSession(artifact_cache=tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_session()
    assert DesignService(device="cpu").session.device.type == "cpu"
    given = DesignSession(device="cpu")
    assert DesignService(given).session is given


def test_launch_counts_exact_under_threads():
    """8 threads count 10,000 launches each, with the interpreter's switch
    interval cut so a lost read-modify-write update would show: exactly
    80,000."""
    name = "threaded_count_probe"
    LAUNCHES.pop(name, None)
    start = threading.Barrier(8)

    def worker():
        start.wait()
        for _ in range(10_000):
            count_launch(name)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert LAUNCHES[name] == 80_000
    finally:
        sys.setswitchinterval(interval)
        LAUNCHES.pop(name, None)


def test_count_launch_holds_the_lock():
    """`count_launch` increments under `kernels.LOCK`: while the lock is
    held elsewhere, a counting thread waits and nothing is counted."""
    from repro_torch.kernels import LOCK

    name = "locked_count_probe"
    LAUNCHES.pop(name, None)
    t = threading.Thread(target=count_launch, args=(name, 3))
    try:
        with LOCK:
            t.start()
            t.join(timeout=0.2)
            assert t.is_alive() and LAUNCHES[name] == 0
        t.join(timeout=60)
        assert not t.is_alive() and LAUNCHES[name] == 3
    finally:
        LAUNCHES.pop(name, None)


def test_session_fields_match_reference():
    """The payload and provenance types carry the reference's fields."""
    from repro.api import session as rsession
    from repro_torch.api import session as tsession

    for cls in ("Provenance", "BucketResult", "ExploredBatch",
                "DistilledBatch", "LayoutBucket"):
        mine = [f.name for f in dataclasses.fields(getattr(tsession, cls))]
        ref = [f.name for f in dataclasses.fields(getattr(rsession, cls))]
        assert mine == ref, cls
