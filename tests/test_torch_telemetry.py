"""The port's telemetry (`repro_torch.telemetry`) and lock sanitizer on
the CPU: spans and the trace export, the metrics registry and
`percentile`, prometheus rendering, the feedback controller on synthetic
clocks, the service integration (span sums vs busy clocks, latency
histogram, pool grow / shrink), and the sanitizer catching an order
inversion.  Pure functions are held exactly to the reference's on the
same inputs: the same strings, floats and decisions."""
import dataclasses
import json
import threading
import time

import numpy as np
import pytest

from repro import telemetry as rtel
from repro.runtime import lock_sanitizer as rls
from repro_torch import telemetry as ttel
from repro_torch.api import DesignRequest, DesignSession, Requirements
from repro_torch.runtime import lock_sanitizer as ls
from repro_torch.serve.design_service import DesignService
from repro_torch.telemetry import (DEFAULT_LATENCY_BUCKETS, METRICS_SCHEMA,
                                   TRACE_SCHEMA, ControllerConfig,
                                   FeedbackController, Histogram,
                                   MetricsRegistry, SpanRecorder, Telemetry,
                                   TraceExport, atomic_write_json,
                                   load_snapshot, percentile,
                                   render_prometheus, write_metrics_json)
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

pytestmark = pytest.mark.timeout(300)

POP, GENS = 48, 10
# one spec of the 4096 front at seed 0, two at seed 1: quick plain routing
LAID = Requirements(min_snr_db=25.0, min_tops=0.3)


def _request(array_size=4096, seed=0, **kw):
    kw.setdefault("pop_size", POP)
    kw.setdefault("generations", GENS)
    kw.setdefault("layout", False)
    return DesignRequest(array_size=array_size, seed=seed, **kw)


class _Clock:
    """Deterministic monotonic clock for recorder/controller tests."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def test_schema_stamps_equal_reference():
    assert (METRICS_SCHEMA, TRACE_SCHEMA) == (rtel.METRICS_SCHEMA,
                                              rtel.TRACE_SCHEMA)
    assert DEFAULT_LATENCY_BUCKETS == rtel.DEFAULT_LATENCY_BUCKETS
    assert sorted(ttel.__all__) == sorted(rtel.__all__)


# -- percentile and histograms -------------------------------------------

class TestPercentile:
    @pytest.mark.parametrize("n", [1, 2, 3, 10, 101])
    def test_equals_reference_and_numpy(self, n):
        rng = np.random.default_rng(7 + n)
        xs = rng.uniform(-50, 50, size=n).tolist()
        for q in (0, 1, 25, 50, 75, 95, 99, 100):
            assert percentile(xs, q) == rtel.percentile(xs, q)
            assert percentile(xs, q) == pytest.approx(
                float(np.percentile(xs, q)), abs=1e-12)

    def test_edge_contracts(self):
        with pytest.raises(ValueError, match="empty"):
            percentile([], 50)
        with pytest.raises(ValueError, match="outside"):
            percentile([1.0], 101)
        assert percentile([3.0], 95) == 3.0


class TestHistogram:
    def test_buckets_and_summary(self):
        h = Histogram("lat", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.1, 0.5, 5.0, 50.0):
            h.observe(v)
        d = h.to_dict()
        assert [c for _, c in d["buckets"]] == [2, 1, 1]   # le inclusive
        assert d["inf_count"] == 1 and d["count"] == 5
        with pytest.raises(ValueError, match="ascending"):
            Histogram("bad", buckets=(1.0, 1.0))

    def test_equals_reference_on_the_same_observations(self):
        rng = np.random.default_rng(11)
        xs = np.exp(rng.normal(-3.0, 2.0, size=500)).tolist()
        mine = Histogram("design_ticket_latency_seconds", "h")
        ref = rtel.Histogram("design_ticket_latency_seconds", "h")
        for v in xs:
            mine.observe(v)
            ref.observe(v)
        assert mine.to_dict() == ref.to_dict()
        assert mine.summary() == ref.summary()

    def test_default_buckets_are_log_spaced(self):
        assert DEFAULT_LATENCY_BUCKETS[0] == pytest.approx(0.001)
        ratios = {b2 / b1 for b1, b2 in zip(DEFAULT_LATENCY_BUCKETS,
                                            DEFAULT_LATENCY_BUCKETS[1:])}
        assert ratios == {2.0}


# -- the registry and prometheus text ------------------------------------

def _fill(reg, hist_values):
    """The same metrics in either package's registry."""
    box = {"n": 7}
    reg.counter("jobs_total", "jobs", labels={"kind": "a"}).inc(3)
    reg.counter("jobs_total", "jobs", labels={"kind": 'b"\n\\'}).inc(0.5)
    reg.counter("proxied_total", "p", fn=lambda: box["n"])
    reg.gauge("depth", "queue depth", fn=lambda: 2)
    reg.gauge("9bad name", "escaped").set(1.25)
    h = reg.histogram("lat_seconds", "latency", buckets=(0.5, 1.0))
    for v in hist_values:
        h.observe(v)
    return reg


class TestMetrics:
    def test_counter_gauge_fn_proxy_wins(self):
        reg = MetricsRegistry()
        box = {"n": 0}
        c = reg.counter("widgets_total", "w", fn=lambda: box["n"])
        box["n"] = 7
        assert c.value == 7.0
        assert reg.gauge("depth", fn=lambda: 3).value == 3.0
        assert reg.counter("widgets_total") is c
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("widgets_total")
        a = reg.counter("served", labels={"tier": "cache"})
        assert a is not reg.counter("served", labels={"tier": "explorer"})

    def test_prometheus_text_equals_reference(self):
        vals = [0.25, 2.0, 0.75, 0.5]
        mine = _fill(MetricsRegistry(), vals).snapshot()
        ref = _fill(rtel.MetricsRegistry(), vals).snapshot()
        mine.pop("time_unix_s")
        ref.pop("time_unix_s")
        assert mine == ref
        text = render_prometheus(mine)
        assert text == rtel.render_prometheus(mine) == \
            rtel.render_prometheus(ref)
        assert 'jobs_total{kind="a"} 3' in text
        assert 'lat_seconds_bucket{le="+Inf"} 4' in text

    def test_service_scrape_renders_the_same_in_both(self):
        """A port service's snapshot renders to the same text through
        the reference's renderer."""
        svc = DesignService(device="cpu")
        svc.run()
        snap = svc.metrics()
        assert render_prometheus(snap) == rtel.render_prometheus(snap)

    def test_json_snapshots_roundtrip(self, tmp_path):
        snap = _fill(MetricsRegistry(), [0.1]).snapshot()
        path = tmp_path / "m.json"
        write_metrics_json(snap, path)
        assert load_snapshot(path)["metrics"]["depth"][0]["value"] == 2
        assert rtel.load_snapshot(path) == load_snapshot(path)
        with pytest.raises(ValueError, match="schema"):
            render_prometheus({"schema": 0, "metrics": {}})
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"schema": 999}))
        with pytest.raises(ValueError, match="schema"):
            load_snapshot(bad)
        atomic_write_json({"ok": 1}, tmp_path / "x.json")
        assert list(tmp_path.glob("*.tmp")) == []


# -- spans and the trace export -------------------------------------------

class TestSpans:
    def test_span_lifecycle_and_export(self):
        clk = _Clock()
        rec = SpanRecorder(clock=clk)
        s = rec.begin("explore", cat="stage", batch=0, at=clk.t)
        clk.advance(2.0)
        rec.end(s, at=clk.t)
        rec.instant("admit", cat="pump", batch=1)
        clk.advance(1.0)
        rec.begin("layout", cat="stage", batch=0, bucket=(8, 8))
        exp = rec.export()                       # flushes the open span
        assert exp.schema == TRACE_SCHEMA
        assert [sp.name for sp in exp.spans] == ["explore", "admit",
                                                 "layout"]
        assert exp.spans[-1].args["open"] is True
        assert exp.spans[-1].bucket == "(8, 8)"
        assert exp.stage_totals() == pytest.approx({"explore": 2.0,
                                                    "layout": 0.0})

    def test_chrome_trace_equals_reference_and_roundtrips(self, tmp_path):
        def record(rec_cls, clk):
            rec = rec_cls(clock=clk)
            with rec.span("distill", cat="stage", batch=3,
                          worker="distill", requests=4):
                clk.advance(0.5)
            rec.instant("shed", cat="fault", bucket="(4, 4)")
            return rec.export()

        exp = record(SpanRecorder, _Clock())
        ref = record(rtel.SpanRecorder, _Clock())
        assert exp.to_dict() == ref.to_dict()
        evs = exp.to_events()
        assert evs[0]["ph"] == "X" and evs[0]["dur"] == pytest.approx(5e5)
        assert evs[1]["ph"] == "i"
        path = tmp_path / "trace.json"
        exp.to_json(path)
        assert [s.name for s in rtel.TraceExport.from_json(path).spans] == \
            ["distill", "shed"]
        back = TraceExport.from_json(path)
        assert back.stage_totals() == pytest.approx({"distill": 0.5})
        with pytest.raises(ValueError, match="schema"):
            TraceExport.from_dict(dict(json.loads(path.read_text()),
                                       schema=0))

    def test_gantt_groups_by_batch(self):
        clk = _Clock()
        rec = SpanRecorder(clock=clk)
        for b in (0, 1):
            with rec.span("explore", cat="stage", batch=b):
                clk.advance(1.0)
        rec.instant("control", cat="control", window_s=0.1)
        g = rec.export().gantt()
        assert g["schema"] == TRACE_SCHEMA
        assert set(g["batches"]) == {0, 1, -1}
        row = g["batches"][0][0]
        assert row["t1_s"] - row["t0_s"] == pytest.approx(1.0)

    def test_threaded_recording_is_complete(self):
        rec = SpanRecorder()

        def work(i):
            for k in range(50):
                with rec.span("unit", cat="stage", batch=i, k=k):
                    pass
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(rec) == 200


# -- the feedback controller (synthetic clock) ----------------------------

def _script():
    """A tick script: (advance, arrivals_total, backlog, inflight,
    workers) rows that move both the window and the pool."""
    rows, arrivals = [], 0
    for i in range(40):
        arrivals += (12 if i % 7 < 3 else 0)
        rows.append((0.03 + 0.01 * (i % 4), arrivals,
                     8 if 10 <= i < 20 else 0,
                     1 if 10 <= i < 24 else 0))
    return rows


class TestFeedbackController:
    @pytest.mark.parametrize("hysteresis", [1, 3])
    def test_decisions_equal_reference(self, hysteresis):
        cfg = dict(min_window_s=0.01, max_window_s=0.5, target_batch=8,
                   min_workers=1, max_workers=3, hysteresis_ticks=hysteresis,
                   tick_interval_s=0.04)
        mine = FeedbackController(ControllerConfig(**cfg))
        ref = rtel.FeedbackController(rtel.ControllerConfig(**cfg))
        clk, window, workers = _Clock(), 0.05, 1
        for dt, arrivals, backlog, inflight in _script():
            kw = dict(queue_depth=backlog, arrivals_total=arrivals,
                      layout_backlog=backlog, inflight_buckets=inflight,
                      layout_workers=workers, window_s=window)
            d, r = mine.tick(clk.t, **kw), ref.tick(clk.t, **kw)
            assert (d is None) == (r is None)
            if d is not None:
                assert dataclasses.astuple(d) == dataclasses.astuple(r)
                window, workers = d.window_s, d.workers
            assert mine.arrival_rate == ref.arrival_rate
            clk.advance(dt)
        assert len(mine.decisions) >= 3
        assert {d.workers for d in mine.decisions} >= {1, 2}

    def test_burst_widens_idle_narrows_window(self):
        cfg = ControllerConfig(min_window_s=0.01, max_window_s=0.5,
                               target_batch=8, window_smoothing=0.0,
                               rate_decay=0.0, tick_interval_s=0.05)
        c, clk = FeedbackController(cfg), _Clock()
        assert c.tick(clk.t, queue_depth=0, arrivals_total=0,
                      layout_backlog=0, inflight_buckets=0,
                      layout_workers=1, window_s=0.01) is None
        clk.advance(1.0)         # 40 arrivals/s: ideal window 8/40 = 0.2
        d = c.tick(clk.t, queue_depth=0, arrivals_total=40,
                   layout_backlog=0, inflight_buckets=0, layout_workers=1,
                   window_s=0.01)
        assert d.window_s == pytest.approx(0.2)

    def test_config_validation(self):
        with pytest.raises(ValueError, match="min_window_s"):
            ControllerConfig(min_window_s=0.0)
        with pytest.raises(ValueError, match="min_workers"):
            ControllerConfig(min_workers=2, max_workers=1)
        with pytest.raises(ValueError, match="hysteresis"):
            ControllerConfig(hysteresis_ticks=0)


# -- the service integration ----------------------------------------------

class TestServiceTelemetry:
    def test_metrics_work_without_telemetry_opt_in(self):
        svc = DesignService(device="cpu")
        assert svc.trace() is None
        snap = svc.metrics()
        assert snap["schema"] == METRICS_SCHEMA
        stages = {s["labels"].get("stage")
                  for s in snap["metrics"]["design_stage_busy_seconds"]}
        assert stages == {"explore", "distill", "layout", "finalize"}

    def test_gantt_totals_agree_with_busy_clocks_k1(self):
        # single-occupant stages: the span edges share the busy clocks'
        # monotonic reads, so per-stage span sums equal the busy clocks
        svc = DesignService(max_coalesce=1, layout_workers=1,
                            telemetry=True, device="cpu")
        with svc.serve():
            tickets = [svc.submit(_request(seed=sd, requirements=LAID,
                                           layout=True))
                       for sd in (0, 1)]
            arts = [svc.collect(t, timeout=120) for t in tickets]
        assert all(a.ok for a in arts)
        totals = svc.trace().stage_totals()
        busy = svc.stats()["stage_busy_s"]
        for stage in ("explore", "distill", "layout", "finalize"):
            assert totals[stage] == pytest.approx(busy[stage], abs=1e-9)
        g = svc.trace().gantt()
        for seq in (0, 1):
            assert {r["name"] for r in g["batches"][seq]
                    if r["cat"] == "stage"} == {"explore", "distill",
                                                "layout", "finalize"}
        session_spans = {s.name for s in svc.trace().spans
                         if s.cat == "session"}
        assert {"explore_dispatch", "layout_bucket"} <= session_spans

    def test_metrics_latency_histogram_and_tiers(self, tmp_path):
        req = _request(seed=0)
        svc = DesignService(DesignSession(artifact_cache=tmp_path,
                                          device="cpu"), telemetry=True)
        with svc.serve():
            a1 = svc.collect(svc.submit(req), timeout=120)
        svc2 = DesignService(DesignSession(artifact_cache=tmp_path,
                                           device="cpu"))
        with svc2.serve():
            a2 = svc2.collect(svc2.submit(req), timeout=120)
        assert a1.summary() == a2.summary()
        for s, tier in ((svc, "explorer"), (svc2, "artifact_cache")):
            snap = s.metrics()
            lat = snap["metrics"]["design_ticket_latency_seconds"][0]
            assert lat["count"] == 1 and lat["summary"]["p50"] > 0
            tiers = {t["labels"]["tier"]: t["value"] for t in
                     snap["metrics"]["design_tickets_served_total"]}
            assert tiers[tier] == 1.0
        text = render_prometheus(svc.metrics())
        assert "design_ticket_latency_seconds_bucket" in text
        assert 'design_tickets_served_total{tier="explorer"} 1' in text

    def test_mid_batch_snapshot_flushes_open_clocks(self):
        svc = DesignService(telemetry=True, device="cpu")
        t0 = time.monotonic() - 1.0
        with svc._lock:
            svc._mark("explore", busy=True, now=t0)
        open_span = svc.recorder.begin("explore", cat="stage", at=t0)
        try:
            st = svc.stats()
            assert st["stage_busy_s"]["explore"] >= 1.0
            assert st["stage_busy"]["explore"] is True
            busy = {s["labels"]["stage"]: s["value"] for s in
                    svc.metrics()["metrics"]["design_stage_busy_seconds"]}
            assert busy["explore"] >= 1.0
            assert svc.trace().stage_totals()["explore"] >= 1.0
        finally:
            with svc._lock:
                svc._mark("explore", busy=False)
            svc.recorder.end(open_span)

    def test_pool_grow_shrink_conserves_sentinels(self):
        svc = DesignService(max_coalesce=1, layout_workers=1,
                            telemetry=True, device="cpu")
        with svc.serve():
            with svc._lock:
                svc._grow_pool()
                svc._grow_pool()
            tickets = [svc.submit(_request(seed=sd, requirements=LAID,
                                           layout=True))
                       for sd in (0, 1)]
            with svc._lock:
                svc._shrink_pool()
            arts = [svc.collect(t, timeout=120) for t in tickets]
        assert all(a.ok for a in arts)
        st = svc.stats()
        assert st["pool_scale_ups"] == 2 and st["pool_scale_downs"] == 1
        assert svc.layout_workers == 2
        assert not any(t.is_alive() for t in svc._stage_threads)

    def test_adaptive_window_moves_under_load(self):
        cfg = ControllerConfig(min_window_s=0.01, max_window_s=0.3,
                               target_batch=4, tick_interval_s=0.02,
                               window_smoothing=0.0)
        svc = DesignService(max_coalesce=4, coalesce_window_s=0.01,
                            telemetry=True, controller=cfg, device="cpu")
        assert svc.controller.config.target_batch == 4
        with svc.serve():
            tickets = [svc.submit(_request(seed=sd)) for sd in (0, 1, 2)]
            arts = [svc.collect(t, timeout=120) for t in tickets]
        assert all(a.ok for a in arts)
        st = svc.stats()
        assert st["control_window_updates"] == len(
            svc.controller.decisions) >= 1
        cfg = svc.controller.config
        assert cfg.min_window_s <= svc.coalesce_window_s <= cfg.max_window_s
        control = [s for s in svc.trace().spans if s.cat == "control"]
        assert len(control) >= len(svc.controller.decisions)

    def test_telemetry_bundle_shares_recorder_with_session(self):
        tel = Telemetry()
        svc = DesignService(telemetry=tel, device="cpu")
        assert svc.session.recorder is tel.recorder
        assert svc.recorder is tel.recorder
        assert svc.registry is tel.metrics


# -- the lock sanitizer ----------------------------------------------------

class TestLockSanitizer:
    def test_order_inversion_is_caught(self):
        reg = ls.LockOrderRegistry()
        a = ls.InstrumentedLock("A", reg)
        b = ls.InstrumentedLock("B", reg)
        with a:
            with b:
                pass
        reg.assert_clean()          # one order only: clean
        done = threading.Event()

        def other_order():
            with b:
                with a:
                    done.set()
        t = threading.Thread(target=other_order)
        t.start()
        t.join()
        assert done.is_set()
        assert reg.edges() == {("A", "B"): 1, ("B", "A"): 1}
        with pytest.raises(AssertionError, match="inversion"):
            reg.assert_clean()
        # the reference's registry reports the same inversion
        rreg = rls.LockOrderRegistry()
        ra, rb = rls.InstrumentedLock("A", rreg), rls.InstrumentedLock(
            "B", rreg)
        for x, y in ((ra, rb), (rb, ra)):
            with x:
                with y:
                    pass
        assert rreg.find_cycle() == reg.find_cycle() == ["A", "B"]

    def test_same_thread_reacquire_raises_before_blocking(self):
        reg = ls.LockOrderRegistry()
        lock = ls.InstrumentedLock("L", reg)
        with lock:
            with pytest.raises(AssertionError, match="guaranteed deadlock"):
                lock.acquire()
        cond = ls.make_condition(ls.InstrumentedLock("C", reg))
        with cond:
            cond.wait(timeout=0.01)   # release/reacquire is order-checked
        reg.assert_clean()

    def test_env_gate(self, monkeypatch):
        monkeypatch.delenv(ls.ENV_FLAG, raising=False)
        assert not ls.enabled()
        assert not isinstance(ls.make_lock("x"), ls.InstrumentedLock)
        monkeypatch.setenv(ls.ENV_FLAG, "1")
        assert ls.enabled()
        assert isinstance(ls.make_lock("x"), ls.InstrumentedLock)
        assert ls.ENV_FLAG == rls.ENV_FLAG

    def test_service_runs_clean_under_the_sanitizer(self, monkeypatch):
        """The pipelined service with every lock instrumented: no
        inversion of its lock order."""
        monkeypatch.setenv(ls.ENV_FLAG, "1")
        ls.GLOBAL_REGISTRY.reset()
        svc = DesignService(max_coalesce=2, coalesce_window_s=0.02,
                            telemetry=True, device="cpu")
        assert isinstance(svc._lock, ls.InstrumentedLock)
        with svc.serve():
            tickets = [svc.submit(_request(seed=sd)) for sd in (0, 1, 2)]
            assert all(svc.collect(t, timeout=120).ok for t in tickets)
            svc.stats()
            svc.metrics()
        ls.GLOBAL_REGISTRY.assert_clean()
        assert ("DesignService._lock", "DesignSession.stats_lock") in \
            ls.GLOBAL_REGISTRY.edges()
        ls.GLOBAL_REGISTRY.reset()
