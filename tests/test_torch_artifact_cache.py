"""The port's persistent artifact cache (`repro_torch.api.artifact_cache`)
on the CPU: round trips, LRU / TTL pruning, rejection of foreign or
corrupt entries, the L1 / L2 tiers with promotion, the ticket journal,
a warm second process served from disk, and interchange with the JAX
reference's `ArtifactCache` / `TicketJournal` in both directions (the
two packages share `DesignRequest.sha()` and the artifact schema)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest

from repro.api import artifact_cache as rcache
from repro.api import request as rrequest
from repro.api import session as rsession
from repro_torch.api import (ArtifactCache, DesignArtifact, DesignRequest,
                             DesignSession, FileRemoteStore, Requirements,
                             TicketJournal, TieredArtifactCache)
from repro_torch.api.artifact_cache import JOURNAL_NAME
from repro_torch.api.session import ARTIFACT_SCHEMA
from repro_torch.core.explorer import ParetoResult
import torch_port_helpers  # noqa: F401  (one torch thread per test worker)

REPO = pathlib.Path(__file__).resolve().parents[1]
POP, GENS = 48, 10
# keeps one spec of the 4096 front (seed 0), so the plain CPU routing of
# a laid-out request stays under a second
LAID = Requirements(min_snr_db=25.0, min_tops=0.3)


def _request(array_size=4096, seed=0, **kw):
    kw.setdefault("pop_size", POP)
    kw.setdefault("generations", GENS)
    kw.setdefault("layout", False)
    return DesignRequest(array_size=array_size, seed=seed, **kw)


def _ref_request(req: DesignRequest) -> rrequest.DesignRequest:
    return rrequest.DesignRequest.from_dict(req.to_dict())


def _json(x):
    """Compare summaries in JSON space (tuples became lists on disk)."""
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def laid_artifact():
    """One real, laid-out port artifact (built once per module)."""
    art = DesignSession(device="cpu").run(
        _request(requirements=LAID, layout=True))
    assert art.ok and art.layout_rows
    return art


# -- round trips ---------------------------------------------------------

class TestArtifactCache:
    def test_put_get_roundtrip(self, tmp_path, laid_artifact):
        cache = ArtifactCache(tmp_path / "cache")
        req = laid_artifact.request
        assert cache.get(req) is None and cache.stats["misses"] == 1
        path = cache.put(laid_artifact)
        assert path.name == f"{req.sha()}.json"
        assert req in cache and len(cache) == 1
        back = cache.get(req)
        assert back.summary() == laid_artifact.summary()
        assert back.provenance == laid_artifact.provenance
        assert cache.stats["hits"] == 1
        assert cache.clear() == 1 and len(cache) == 0

    def test_artifact_and_front_json_roundtrip(self, tmp_path,
                                               laid_artifact):
        path = tmp_path / "artifact.json"
        laid_artifact.to_json(path)
        back = DesignArtifact.from_json(path)
        assert back.summary() == laid_artifact.summary()
        assert back.request == laid_artifact.request
        front = laid_artifact.pareto
        front.to_json(tmp_path / "front.json")
        again = ParetoResult.from_json(tmp_path / "front.json")
        assert again.to_rows() == front.to_rows()
        assert again.best("snr_db") == front.best("snr_db")
        assert again.best("area_f2_per_bit", maximize=False) == \
            front.best("area_f2_per_bit", maximize=False)
        with pytest.raises(ValueError, match="empty Pareto"):
            ParetoResult.from_rows(4096, []).best("tops")

    def test_corrupt_entry_is_counted_miss(self, tmp_path, laid_artifact):
        cache = ArtifactCache(tmp_path)
        path = cache.put(laid_artifact)
        path.write_text(path.read_text()[: len(path.read_text()) // 2])
        assert cache.get(laid_artifact.request) is None
        assert cache.stats["rejects"] == 1 and cache.stats["misses"] == 1

    def test_foreign_schema_is_counted_miss(self, tmp_path, laid_artifact):
        cache = ArtifactCache(tmp_path)
        path = cache.put(laid_artifact)
        d = json.loads(path.read_text())
        assert d["schema"] == ARTIFACT_SCHEMA == rsession.ARTIFACT_SCHEMA
        d["schema"] = 999
        path.write_text(json.dumps(d))
        assert cache.get(laid_artifact.request) is None
        assert cache.stats["rejects"] == 1
        with pytest.raises(ValueError, match="schema 999"):
            DesignArtifact.from_dict(d)

    def test_key_collision_guard(self, tmp_path, laid_artifact):
        # an entry parked under another request's sha must not be served
        cache = ArtifactCache(tmp_path)
        other = dataclasses.replace(laid_artifact.request, seed=123)
        cache.put(laid_artifact)
        os.replace(cache.path_for(laid_artifact.request),
                   cache.path_for(other))
        assert cache.get(other) is None
        assert cache.stats["rejects"] == 1

    def test_atomic_write_preserves_previous_file(self, tmp_path,
                                                  laid_artifact):
        path = tmp_path / "artifact.json"
        laid_artifact.to_json(path)
        good = path.read_text()
        bad = dataclasses.replace(laid_artifact, layout_rows=(object(),))
        with pytest.raises(TypeError):
            bad.to_json(path)
        assert path.read_text() == good            # target never truncated
        assert list(tmp_path.iterdir()) == [path]  # no temp litter

    def test_session_serves_repeat_from_disk(self, tmp_path):
        req = _request(requirements=LAID, layout=True)
        s1 = DesignSession(artifact_cache=tmp_path, device="cpu")
        a1 = s1.run(req)
        assert a1.provenance.served_from == "explorer"
        assert s1.stats["artifact_cache_writes"] == 1
        # a FRESH session (fresh in-memory caches) hits the disk tier
        s2 = DesignSession(artifact_cache=ArtifactCache(tmp_path),
                           device="cpu")
        a2 = s2.run(req)
        assert a2.provenance.served_from == "artifact_cache"
        assert a2.provenance.explorer_dispatches == 0
        assert s2.stats["explorer_dispatches"] == 0
        assert s2.stats["layout_dispatches"] == 0
        assert s2.stats["artifact_cache_hits"] == 1
        assert a2.summary() == a1.summary()

    def test_error_artifacts_are_not_cached(self, tmp_path):
        ses = DesignSession(artifact_cache=tmp_path, device="cpu")
        bad = _request(requirements=Requirements(min_tops=1e9), layout=True)
        art = ses.run_many([bad], strict=False)[bad]
        assert not art.ok
        assert ses.stats["artifact_cache_writes"] == 0
        assert len(ses.artifact_cache) == 0
        err = ses.error_artifact(bad, "boom", pipelined=True,
                                 explore_wait_s=0.5)
        assert not err.ok and err.provenance.served_from == "error"
        assert err.provenance.explore_wait_s == 0.5 and not err.pareto.specs


# -- eviction ------------------------------------------------------------

def _variants(artifact, n):
    """Distinct cache entries: same content under fresh request keys."""
    return [dataclasses.replace(
        artifact, request=dataclasses.replace(artifact.request,
                                              seed=1000 + k))
            for k in range(n)]


class TestArtifactCacheEviction:
    def test_max_entries_prunes_lru_on_put(self, tmp_path, laid_artifact):
        cache = ArtifactCache(tmp_path, max_entries=2)
        v = _variants(laid_artifact, 3)
        for art in v:
            cache.put(art)
            time.sleep(0.02)   # distinct mtimes
        assert len(cache) == 2
        assert cache.stats["lru_evictions"] == 1
        assert cache.stats["prunes"] == 3
        assert cache.get(v[0].request) is None
        assert cache.get(v[1].request) is not None
        assert cache.get(v[2].request) is not None

    def test_get_refreshes_lru_recency(self, tmp_path, laid_artifact):
        cache = ArtifactCache(tmp_path, max_entries=2)
        v = _variants(laid_artifact, 3)
        cache.put(v[0])
        time.sleep(0.02)
        cache.put(v[1])
        time.sleep(0.02)
        assert cache.get(v[0].request) is not None   # touch: v[1] is now LRU
        time.sleep(0.02)
        cache.put(v[2])                              # prune drops v[1]
        assert cache.get(v[1].request) is None
        assert cache.get(v[0].request) is not None

    def test_ttl_expires_old_entries(self, tmp_path, laid_artifact):
        cache = ArtifactCache(tmp_path, ttl_s=60.0)
        v = _variants(laid_artifact, 2)
        path = cache.put(v[0])
        stale = time.time() - 120.0
        os.utime(path, (stale, stale))
        cache.put(v[1])
        assert cache.stats["ttl_evictions"] == 1
        assert cache.get(v[0].request) is None
        assert cache.get(v[1].request) is not None
        assert len(cache) == 1

    def test_fresh_put_never_self_evicts(self, tmp_path, laid_artifact):
        cache = ArtifactCache(tmp_path, max_entries=1, ttl_s=3600.0)
        v = _variants(laid_artifact, 2)
        cache.put(v[0])
        time.sleep(0.02)
        cache.put(v[1])
        assert cache.get(v[1].request) is not None
        assert len(cache) == 1

    def test_get_refreshed_mtime_survives_ttl_prune(self, tmp_path,
                                                    laid_artifact):
        cache = ArtifactCache(tmp_path, ttl_s=50.0)
        v = _variants(laid_artifact, 2)
        touched = cache.put(v[0])
        untouched = cache.put(v[1])
        stale = time.time() - 100.0                       # both expired
        os.utime(touched, (stale, stale))
        os.utime(untouched, (stale, stale))
        assert cache.get(v[0].request) is not None        # refresh mtime
        cache._prune()
        assert cache.get(v[0].request) is not None
        assert cache.get(v[1].request) is None
        assert cache.stats["ttl_evictions"] == 1

    def test_max_entries_bound_holds_under_concurrent_puts(
            self, tmp_path, laid_artifact):
        cache = ArtifactCache(tmp_path, max_entries=3)
        v = _variants(laid_artifact, 12)
        errors = []

        def putter(arts):
            try:
                for a in arts:
                    cache.put(a)
            except Exception as e:
                errors.append(e)
        threads = [threading.Thread(target=putter, args=(v[i::4],))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        cache._prune()
        assert len(cache) <= 3

    def test_knob_validation_and_unbounded(self, tmp_path, laid_artifact):
        with pytest.raises(ValueError, match="max_entries"):
            ArtifactCache(tmp_path, max_entries=0)
        with pytest.raises(ValueError, match="ttl_s"):
            ArtifactCache(tmp_path, ttl_s=0)
        cache = ArtifactCache(tmp_path / "flat")
        for art in _variants(laid_artifact, 3):
            cache.put(art)
        assert len(cache) == 3 and cache.stats["prunes"] == 0


# -- the L1 / L2 tiers ---------------------------------------------------

class TestFileRemoteStore:
    def test_uri_and_roundtrip(self, tmp_path):
        store = FileRemoteStore(f"file://{tmp_path}/l2")
        assert store.uri == f"file://{tmp_path}/l2"
        assert store.get("a.json") is None
        store.put("a.json", b"{}")
        assert store.get("a.json") == b"{}"
        assert store.list() == ["a.json"]
        assert store.size_bytes() == 2
        assert store.delete("a.json") and not store.delete("a.json")
        assert store.list() == []
        plain = FileRemoteStore(tmp_path / "plain")
        plain.put("x.json", b"1")
        assert FileRemoteStore(f"file://{tmp_path}/plain").get(
            "x.json") == b"1"

    @pytest.mark.parametrize("key", ["", ".", "..", "a/b.json"])
    def test_invalid_keys_rejected(self, tmp_path, key):
        with pytest.raises(ValueError):
            FileRemoteStore(tmp_path).put(key, b"x")


class TestTieredArtifactCache:
    def test_cascade_promotion_and_counters(self, tmp_path, laid_artifact):
        req = laid_artifact.request
        writer = TieredArtifactCache(tmp_path / "w1", tmp_path / "l2")
        writer.put(laid_artifact)
        assert writer.lengths() == {"l1": 1, "l2": 1}
        assert writer.stats["l2_writes"] == 1
        assert req in writer
        # fresh worker, cold L1, same L2: served from l2 then promoted
        reader = TieredArtifactCache(tmp_path / "w2", tmp_path / "l2")
        got, tier = reader.get_with_tier(req)
        assert tier == "l2" and got.summary() == laid_artifact.summary()
        assert reader.lengths()["l1"] == 1
        got, tier = reader.get_with_tier(req)
        assert tier == "l1"
        assert reader.stats == {"l1_misses": 1, "l2_hits": 1,
                                "promotions": 1, "l1_hits": 1}

    def test_l2_guards_mirror_l1(self, tmp_path):
        req = _request()
        cache = TieredArtifactCache(tmp_path / "l1", tmp_path / "l2")
        key = cache.key_for(req)
        cache.remote.put(key, b"not json")
        assert cache.get_with_tier(req) == (None, None)
        assert cache.stats["l2_rejects"] == 1
        cache.remote.put(key, json.dumps(
            {"schema": -1, "request": req.to_dict()}).encode())
        assert cache.get(req) is None
        assert cache.stats["l2_rejects"] == 2
        assert cache.lengths()["l1"] == 0

    def test_clear_and_prune_by_tier(self, tmp_path, laid_artifact):
        cache = TieredArtifactCache(tmp_path / "l1", tmp_path / "l2")
        for art in _variants(laid_artifact, 3):
            cache.put(art)
        assert cache.lengths() == {"l1": 3, "l2": 3}
        assert cache.prune(tier="l2", max_entries=2) == 1
        assert cache.lengths() == {"l1": 3, "l2": 2}
        assert cache.stats["l2_evictions"] == 1
        assert cache.clear(tier="l1") == 3
        assert cache.lengths() == {"l1": 0, "l2": 2}
        assert cache.clear() == 2
        assert cache.lengths() == {"l1": 0, "l2": 0}

    def test_session_stamps_tiers(self, tmp_path):
        """explorer -> l2 (cold L1 worker) -> l1, with the session
        mirroring per-tier counters."""
        req = _request(seed=7)
        w1 = DesignSession(artifact_cache=TieredArtifactCache(
            tmp_path / "w1", tmp_path / "shared"), device="cpu")
        a1 = w1.run(req)
        assert a1.provenance.served_from == "explorer"
        assert w1.stats["artifact_cache_l2_writes"] == 1
        w2 = DesignSession(artifact_cache=TieredArtifactCache(
            tmp_path / "w2", tmp_path / "shared"), device="cpu")
        a2 = w2.run(req)
        assert a2.provenance.served_from == "artifact_cache_l2"
        assert w2.stats["explorer_dispatches"] == 0
        assert w2.stats["artifact_cache_promotions"] == 1
        assert a2.summary() == a1.summary()
        a3 = w2.run(req)   # the artifact cache is consulted before the memo
        assert a3.provenance.served_from == "artifact_cache_l1"
        assert w2.stats["artifact_cache_l1_hits"] == 1

    def test_single_tier_stamp(self, tmp_path):
        req = _request(seed=9)
        cache = ArtifactCache(tmp_path / "flat")
        DesignSession(artifact_cache=cache, device="cpu").run(req)
        again = DesignSession(artifact_cache=cache, device="cpu").run(req)
        assert again.provenance.served_from == "artifact_cache"


# -- the ticket journal --------------------------------------------------

class TestTicketJournal:
    def test_write_replay_roundtrip_preserves_order(self, tmp_path):
        j = TicketJournal(tmp_path / "wal" / "journal.jsonl")
        reqs = [_request(seed=sd) for sd in (3, 1, 2)]
        assert j.write(reqs) == 3
        assert len(j) == 3
        assert j.replay() == reqs        # admission order, not seed order
        assert j.replay() == reqs        # replay does NOT clear
        j.clear()
        assert j.replay() == [] and len(j) == 0

    def test_write_is_full_rewrite_and_empty_clears(self, tmp_path):
        j = TicketJournal(tmp_path / "journal.jsonl")
        j.write([_request(seed=1)])
        j.write([_request(seed=2)])
        assert [r.seed for r in j.replay()] == [2]   # replaced, not appended
        j.write([])
        assert not j.path.exists()

    def test_corrupt_line_skipped_and_counted(self, tmp_path):
        j = TicketJournal(tmp_path / "journal.jsonl")
        good = _request(seed=9)
        j.path.write_text("this is not json\n" + good.to_json() + "\n")
        assert j.replay() == [good]
        assert j.stats["rejects"] == 1

    def test_beside_cache_colocation(self, tmp_path):
        cache = ArtifactCache(tmp_path / "cache")
        assert TicketJournal.beside(cache).path == cache.root / JOURNAL_NAME
        assert JOURNAL_NAME == rcache.JOURNAL_NAME


# -- a warm second process -----------------------------------------------

@pytest.mark.parametrize("tiered", [False, True], ids=["l1", "l2"])
def test_warm_second_process_serves_from_disk(tmp_path, laid_artifact,
                                              tiered):
    """A fresh process over the cache serves the repeat request with zero
    explorer and layout dispatches (and zero kernel launches); over a
    cold L1 and the first worker's L2 it serves from l2 and promotes."""
    req = laid_artifact.request
    remote = f"file://{tmp_path}/shared"
    if tiered:
        TieredArtifactCache(tmp_path / "w1", remote).put(laid_artifact)
    else:
        ArtifactCache(tmp_path / "w1").put(laid_artifact)
    args = [sys.executable, str(REPO / "tests" /
                                "torch_cache_roundtrip_helper.py"),
            str(tmp_path / ("w2" if tiered else "w1")), req.to_json()]
    if tiered:
        args += ["--remote", remote]
    r = subprocess.run(args, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    report = json.loads(r.stdout)
    assert report["ok"]
    assert report["explorer_dispatches"] == 0
    assert report["layout_dispatches"] == 0
    assert report["launches"] == 0
    assert report["artifact_cache_hits"] == 1
    assert report["summary"] == _json(laid_artifact.summary())
    if tiered:
        assert report["served_from"] == "artifact_cache_l2"
        assert report["tier_stats"]["artifact_cache_promotions"] == 1
        assert any((tmp_path / "w2").glob("*.json"))
    else:
        assert report["served_from"] == "artifact_cache"


# -- interchange with the JAX reference ----------------------------------

class TestInterchange:
    def test_reference_cache_serves_port_entry(self, tmp_path,
                                               laid_artifact):
        ArtifactCache(tmp_path).put(laid_artifact)
        ref_req = _ref_request(laid_artifact.request)
        assert ref_req.sha() == laid_artifact.request.sha()
        cache = rcache.ArtifactCache(tmp_path)
        got = cache.get(ref_req)
        assert got is not None and cache.stats["hits"] == 1
        assert _json(got.summary()) == _json(laid_artifact.summary())
        assert dataclasses.asdict(got.provenance) == \
            dataclasses.asdict(laid_artifact.provenance)
        # and through the reference's tiered cache as an L2 object
        TieredArtifactCache(tmp_path / "p1", tmp_path / "l2").put(
            laid_artifact)
        tiered = rcache.TieredArtifactCache(tmp_path / "r1",
                                            tmp_path / "l2")
        got, tier = tiered.get_with_tier(ref_req)
        assert tier == "l2"
        assert _json(got.summary()) == _json(laid_artifact.summary())

    def test_port_cache_serves_reference_entry(self, tmp_path):
        """An entry the reference's session wrote (a real JAX run) under
        the same `sha()` path is served by the port's session."""
        req = _request(seed=3, requirements=LAID)
        ref_req = _ref_request(req)
        ref_art = rsession.DesignSession(
            artifact_cache=rcache.ArtifactCache(tmp_path)).run(ref_req)
        assert (tmp_path / f"{req.sha()}.json").exists()
        session = DesignSession(artifact_cache=tmp_path, device="cpu")
        art = session.run(req)
        assert art.provenance.served_from == "artifact_cache"
        assert session.stats["explorer_dispatches"] == 0
        assert art.request == req
        assert _json(art.summary()) == _json(ref_art.summary())

    def test_reference_replays_port_journal(self, tmp_path):
        reqs = [_request(seed=sd, requirements=LAID) for sd in (5, 2, 8)]
        TicketJournal(tmp_path / JOURNAL_NAME).write(reqs)
        back = rcache.TicketJournal(tmp_path / JOURNAL_NAME).replay()
        assert [r.to_dict() for r in back] == [r.to_dict() for r in reqs]
        assert [r.sha() for r in back] == [r.sha() for r in reqs]

    def test_port_replays_reference_journal(self, tmp_path):
        reqs = [_request(seed=sd) for sd in (4, 0, 6)]
        rcache.TicketJournal(tmp_path / JOURNAL_NAME).write(
            [_ref_request(r) for r in reqs])
        assert TicketJournal(tmp_path / JOURNAL_NAME).replay() == reqs
