"""Persistent, cross-process artifact cache keyed by `DesignRequest.sha()`.

Counterpart of the JAX package's `api/artifact_cache.py`.  The
in-memory caches of `repro_torch.api.session.DesignSession` (programs,
Pareto fronts) die with the process; this is the third tier that does
not: a directory of artifact JSON files that any number of sessions —
in any number of processes, on a shared filesystem — read before
exploring and write after each run.  A warm second process serves a
repeat request with **zero** explorer dispatches
(`tests/test_torch_artifact_cache.py` asserts this through a real
subprocess).

Layout:

    <root>/<request.sha()>.json     one complete DesignArtifact dump

The port's `DesignRequest.sha()` and artifact schema equal the
reference's, so either package's cache serves the other's entries when
both are given the same root; nothing is shared unless a caller passes
the same path (the port has no default cache directory).

Each entry is exactly `DesignArtifact.to_dict()` — it carries a
top-level `"schema"` stamp (`repro_torch.api.session.ARTIFACT_SCHEMA`) and
the full request dict, so `get()` can reject entries written by a
different schema generation and guard the truncated-sha key against
collisions by comparing the embedded request with the queried one.

Concurrency: writes go through `DesignArtifact.to_json`'s temp-file +
`os.replace` path, so readers only ever observe complete files — two
processes racing to fill the same key both succeed, last writer wins
with identical content.  A corrupt / half-migrated / foreign file is a
counted miss (`cache.stats["rejects"]`, alongside `"hits"`/
`"misses"`/`"writes"` — the session mirrors hits/misses/writes into
its own `stats` as `artifact_cache_*`), never an exception: the caller
just recomputes and overwrites it.

Eviction (for long-lived fleets): `max_entries` bounds the entry count
with LRU-by-mtime pruning, `ttl_s` expires entries whose mtime is
older than the window; both run on `put` (`_prune`), and a `get` hit
refreshes the entry's mtime so hot requests survive the LRU.  Evicted
counts land in `stats["ttl_evictions"]` / `stats["lru_evictions"]`
(plus `stats["prunes"]` per pass).  Eviction is best-effort under
concurrency: two processes pruning the same directory both succeed
(unlink errors are ignored), and a racing reader of an evicted entry
just records a miss and recomputes.

Beside the cache lives the **ticket journal** (`TicketJournal`, file
`journal.jsonl` in the cache root): the preemption WAL of
`repro_torch.serve.design_service.DesignService`.  On SIGTERM the service
drains its in-flight stages and writes every unfinished ticket's
`DesignRequest` JSON — one line each, admission order preserved — via
the same temp-file + `os.replace` atomicity as cache entries; a
restarted service replays the journal (resubmitting the requests in
order, artifacts re-stamped `served_from="journal_replay"`).  Drained
work that reached the cache before the process died is served from
disk on replay, so replay converges instead of recomputing the world.
"""
from __future__ import annotations

import collections
import json
import os
import pathlib
import tempfile
import time

from repro_torch.api.request import DesignRequest
from repro_torch.api.session import ARTIFACT_SCHEMA, DesignArtifact

JOURNAL_NAME = "journal.jsonl"


class ArtifactCache:
    """Disk store of `DesignArtifact`s, keyed by `DesignRequest.sha()`."""

    def __init__(self, root, *, max_entries: int | None = None,
                 ttl_s: float | None = None) -> None:
        if max_entries is not None and max_entries <= 0:
            raise ValueError("max_entries must be positive (or None)")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError("ttl_s must be positive (or None)")
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self.stats: collections.Counter = collections.Counter()
        self._puts_since_prune = 0

    def path_for(self, request: DesignRequest) -> pathlib.Path:
        return self.root / f"{request.sha()}.json"

    def get(self, request: DesignRequest) -> DesignArtifact | None:
        """The cached artifact for `request`, or `None` on any kind of
        miss (absent, unreadable, schema skew, sha collision)."""
        path = self.path_for(request)
        try:
            with open(path) as f:
                d = json.load(f)
        except FileNotFoundError:
            self.stats["misses"] += 1
            return None
        except (OSError, json.JSONDecodeError):
            self.stats["misses"] += 1
            self.stats["rejects"] += 1
            return None
        if (not isinstance(d, dict)
                or d.get("schema") != ARTIFACT_SCHEMA
                or d.get("request") != request.to_dict()):
            self.stats["misses"] += 1
            self.stats["rejects"] += 1
            return None
        try:
            artifact = DesignArtifact.from_dict(d)
        except (KeyError, TypeError, ValueError):
            self.stats["misses"] += 1
            self.stats["rejects"] += 1
            return None
        self.stats["hits"] += 1
        try:
            os.utime(path)   # LRU recency: a hit must outlive cold entries
        except OSError:
            pass             # entry raced away / read-only store: still a hit
        return artifact

    def put(self, artifact: DesignArtifact) -> pathlib.Path:
        """Store (atomically), then prune; returns the entry path.

        Pruning costs a full directory scan, so it is amortized: with a
        large `max_entries` it runs once every `max_entries // 8` puts
        (the store may transiently overshoot the bound by 12.5%); with
        a small bound — or a TTL-only cache — it runs on every put."""
        path = self.path_for(artifact.request)
        artifact.to_json(path)
        self.stats["writes"] += 1
        if self.max_entries is not None or self.ttl_s is not None:
            self._puts_since_prune += 1
            if self._puts_since_prune >= max(1, (self.max_entries or 0) // 8):
                self._puts_since_prune = 0
                self._prune()
        return path

    def _prune(self) -> None:
        """TTL expiry + LRU-by-mtime bound.  The entry just written is
        the newest by mtime, so a prune right after `put` can never
        evict it (with `max_entries >= 1`)."""
        self.stats["prunes"] += 1
        now = time.time()
        entries = []
        for p in self.root.glob("*.json"):
            try:
                entries.append((p.stat().st_mtime, p))
            except OSError:
                pass   # raced away under a concurrent prune
        entries.sort()   # oldest first
        drop = []
        if self.ttl_s is not None:
            expired = [e for e in entries if now - e[0] > self.ttl_s]
            self.stats["ttl_evictions"] += len(expired)
            drop += expired
            entries = entries[len(expired):]
        if self.max_entries is not None and len(entries) > self.max_entries:
            lru = entries[:len(entries) - self.max_entries]
            self.stats["lru_evictions"] += len(lru)
            drop += lru
        for _, p in drop:
            try:
                os.unlink(p)
            except OSError:
                pass

    def __contains__(self, request: DesignRequest) -> bool:
        return self.path_for(request).exists()

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*.json"))

    def clear(self) -> int:
        """Drop every entry; returns how many were removed."""
        n = 0
        for path in self.root.glob("*.json"):
            try:
                os.unlink(path)
                n += 1
            except OSError:
                pass
        return n

    def __repr__(self) -> str:
        return f"ArtifactCache(root={str(self.root)!r}, entries={len(self)})"


class RemoteStore:
    """The pluggable L2 backend contract of `TieredArtifactCache`: an
    object store keyed by string, bytes-valued, with the classic
    `get`/`put`/`list` shape.  Implementations must make `put` atomic
    from a reader's point of view (readers see the old object or the
    new one, never a torn write) — that is the only consistency the
    tiered cache needs.  `FileRemoteStore` is the filesystem-URI
    reference implementation; an S3/GCS adapter slots in by
    implementing these four methods."""

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def list(self) -> list[str]:
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError


class FileRemoteStore(RemoteStore):
    """`RemoteStore` over a (typically network-shared) directory.

    Accepts a `file://` URI or a plain path.  Objects are files named
    by their key; `put` goes through temp-file + `os.replace`, the same
    atomicity contract as L1 entries, so N fleet workers racing on one
    key all succeed with complete content."""

    def __init__(self, uri) -> None:
        text = os.fspath(uri)
        if text.startswith("file://"):
            text = text[len("file://"):] or "/"
        self.root = pathlib.Path(text)
        self.root.mkdir(parents=True, exist_ok=True)

    @property
    def uri(self) -> str:
        return f"file://{self.root}"

    def _path(self, key: str) -> pathlib.Path:
        if "/" in key or key in ("", ".", ".."):
            raise ValueError(f"invalid object key {key!r}")
        return self.root / key

    def get(self, key: str) -> bytes | None:
        try:
            return self._path(key).read_bytes()
        except (FileNotFoundError, OSError):
            return None

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=str(self.root),
                                   prefix=path.name + ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def list(self) -> list[str]:
        return sorted(p.name for p in self.root.glob("*.json"))

    def delete(self, key: str) -> bool:
        try:
            os.unlink(self._path(key))
            return True
        except OSError:
            return False

    def size_bytes(self) -> int:
        total = 0
        for key in self.list():
            try:
                total += self._path(key).stat().st_size
            except OSError:
                pass
        return total

    def __repr__(self) -> str:
        return f"FileRemoteStore(uri={self.uri!r})"


class TieredArtifactCache:
    """Two-tier artifact store for worker fleets: local disk stays the
    fast L1 (`ArtifactCache`, per worker), a `RemoteStore` becomes the
    shared L2 every worker reads through and writes back to.

    `get` checks L1 first; on an L1 miss the L2 object is fetched,
    validated with exactly the L1 guards (schema stamp, embedded
    request), **promoted** into L1, and served — so the first repeat
    request on a fresh worker costs one remote fetch and every repeat
    after that is local.  `put` writes both tiers.  The session stamps
    which tier served (`provenance.served_from` of
    "artifact_cache_l1" / "artifact_cache_l2") via `get_with_tier`,
    and mirrors the per-tier counters kept here (`stats` keys
    l1_hits/l1_misses/l2_hits/l2_misses/promotions/l2_writes/
    l2_rejects) into the service metrics registry.

    Duck-compatible with `ArtifactCache` where it matters: `.root`
    (ticket journal co-location), `get`/`put`/`clear`/`__len__`/
    `path_for`.  Eviction knobs (`max_entries`/`ttl_s`) apply to L1;
    the shared L2 is pruned explicitly (`prune`) because no single
    worker owns its lifecycle."""

    def __init__(self, root, remote, *, max_entries: int | None = None,
                 ttl_s: float | None = None) -> None:
        self.l1 = ArtifactCache(root, max_entries=max_entries, ttl_s=ttl_s)
        self.remote = (remote if hasattr(remote, "get")
                       else FileRemoteStore(remote))
        self.stats: collections.Counter = collections.Counter()

    @property
    def root(self) -> pathlib.Path:
        return self.l1.root

    def path_for(self, request: DesignRequest) -> pathlib.Path:
        return self.l1.path_for(request)

    @staticmethod
    def key_for(request: DesignRequest) -> str:
        return f"{request.sha()}.json"

    def get(self, request: DesignRequest) -> DesignArtifact | None:
        return self.get_with_tier(request)[0]

    def get_with_tier(self, request: DesignRequest):
        """(artifact, tier) — tier is "l1", "l2", or None on a miss."""
        hit = self.l1.get(request)
        if hit is not None:
            self.stats["l1_hits"] += 1
            return hit, "l1"
        self.stats["l1_misses"] += 1
        data = self.remote.get(self.key_for(request))
        if data is None:
            self.stats["l2_misses"] += 1
            return None, None
        art = self._decode(data, request)
        if art is None:
            self.stats["l2_misses"] += 1
            self.stats["l2_rejects"] += 1
            return None, None
        self.stats["l2_hits"] += 1
        self.l1.put(art)            # promotion: next repeat is local
        self.stats["promotions"] += 1
        return art, "l2"

    def _decode(self, data: bytes,
                request: DesignRequest) -> DesignArtifact | None:
        """Validate an L2 object with the same guards L1 applies: JSON,
        schema stamp, embedded-request equality (truncated-sha key
        collisions), parseability.  Any failure is a counted miss."""
        try:
            d = json.loads(data)
        except (UnicodeDecodeError, json.JSONDecodeError):
            return None
        if (not isinstance(d, dict)
                or d.get("schema") != ARTIFACT_SCHEMA
                or d.get("request") != request.to_dict()):
            return None
        try:
            return DesignArtifact.from_dict(d)
        except (KeyError, TypeError, ValueError):
            return None

    def put(self, artifact: DesignArtifact) -> pathlib.Path:
        path = self.l1.put(artifact)
        self.remote.put(self.key_for(artifact.request),
                        json.dumps(artifact.to_dict()).encode())
        self.stats["l2_writes"] += 1
        return path

    def lengths(self) -> dict:
        return {"l1": len(self.l1), "l2": len(self.remote.list())}

    def __len__(self) -> int:
        return len(self.l1)

    def __contains__(self, request: DesignRequest) -> bool:
        return (request in self.l1
                or self.key_for(request) in self.remote.list())

    def clear(self, tier: str = "all") -> int:
        """Drop entries from one tier ("l1"/"l2") or both ("all");
        returns how many were removed."""
        n = 0
        if tier in ("l1", "all"):
            n += self.l1.clear()
        if tier in ("l2", "all"):
            for key in self.remote.list():
                n += int(self.remote.delete(key))
        return n

    def prune(self, tier: str = "l1", *, max_entries: int | None = None,
              ttl_s: float | None = None) -> int:
        """Explicit eviction pass.  L1 reuses the cache's own policy
        (`_prune`); L2 applies the given bounds over the store's keys
        (TTL by file mtime where the store exposes one, LRU by listing
        order otherwise) — fleet-level maintenance, never automatic."""
        if tier == "l1":
            before = len(self.l1)
            self.l1._prune()
            return before - len(self.l1)
        keys = self.remote.list()
        drop: list[str] = []
        if ttl_s is not None and hasattr(self.remote, "_path"):
            now = time.time()
            aged = []
            for k in keys:
                try:
                    mtime = self.remote._path(k).stat().st_mtime
                except OSError:
                    continue
                aged.append((mtime, k))
            aged.sort()
            drop += [k for m, k in aged if now - m > ttl_s]
            keys = [k for m, k in aged if now - m <= ttl_s]
        if max_entries is not None and len(keys) > max_entries:
            drop += keys[:len(keys) - max_entries]
        removed = sum(int(self.remote.delete(k)) for k in drop)
        self.stats["l2_evictions"] += removed
        return removed

    def __repr__(self) -> str:
        sizes = self.lengths()
        return (f"TieredArtifactCache(root={str(self.root)!r}, "
                f"remote={self.remote!r}, l1={sizes['l1']}, "
                f"l2={sizes['l2']})")


class TicketJournal:
    """Write-ahead log of unfinished `DesignRequest`s, for preemption.

    One JSONL file: each line is `DesignRequest.to_json()`, in the
    admission order of the tickets they came from.  `write()` replaces
    the whole file atomically (temp file + `os.replace`) — the journal
    is rewritten in full at each preemption drain, never appended, so a
    reader can only ever observe a complete, consistent snapshot.
    `replay()` returns the journaled requests in order and does NOT
    clear the file — the replaying service clears it only after the
    resubmitted tickets are safely back in its queue, so a crash
    between read and resubmit loses nothing.  A corrupt line is
    skipped and counted (`stats["rejects"]`), never raised: losing one
    ticket's journal entry must not strand the rest.
    """

    def __init__(self, path) -> None:
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.stats: collections.Counter = collections.Counter()

    @classmethod
    def beside(cls, cache: ArtifactCache) -> "TicketJournal":
        """The journal co-located with an `ArtifactCache` (the layout a
        restarted fleet worker looks for)."""
        return cls(cache.root / JOURNAL_NAME)

    def write(self, requests) -> int:
        """Atomically replace the journal with `requests` (in order);
        an empty sequence clears it.  Returns the entry count."""
        requests = list(requests)
        if not requests:
            self.clear()
            return 0
        text = "".join(r.to_json() + "\n" for r in requests)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name + ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.stats["writes"] += 1
        self.stats["journaled"] += len(requests)
        return len(requests)

    def replay(self) -> list[DesignRequest]:
        """The journaled requests, admission order preserved; `[]` when
        the journal is absent or empty.  Corrupt lines are counted
        (`stats["rejects"]`) and skipped."""
        try:
            lines = self.path.read_text().splitlines()
        except FileNotFoundError:
            return []
        out = []
        for line in lines:
            if not line.strip():
                continue
            try:
                out.append(DesignRequest.from_json(line))
            except (ValueError, KeyError, TypeError, json.JSONDecodeError):
                self.stats["rejects"] += 1
        self.stats["replays"] += 1
        return out

    def clear(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __len__(self) -> int:
        try:
            return sum(1 for line in self.path.read_text().splitlines()
                       if line.strip())
        except FileNotFoundError:
            return 0

    def __repr__(self) -> str:
        return f"TicketJournal(path={str(self.path)!r}, entries={len(self)})"
