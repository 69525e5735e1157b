"""Design sessions: long-lived, cache-owning request execution on the card.

Counterpart of `repro.api.session`.  `DesignSession` runs a
`DesignRequest` end to end (paper Fig. 4: explore -> distill -> layout)
and owns two caches:

  * a *program cache* keyed by `DesignRequest.shape_signature()` — one
    sweep-program entry per signature (the port compiles nothing, so
    `Provenance.new_traces` is always 0);
  * a *front cache* keyed by `DesignRequest.explore_key()` — the
    distillation-independent Pareto front, so a repeat query costs no
    exploration at all;
  * optionally a third, *persistent* tier: a
    `repro_torch.api.artifact_cache.ArtifactCache` (disk store keyed by
    `DesignRequest.sha()`), consulted before exploring and written
    after each run, so processes share results across restarts —
    served artifacts carry `provenance.served_from == "artifact_cache"`
    (`"artifact_cache_l1"` / `"_l2"` from a `TieredArtifactCache`).

Execution is four stages with explicit payload types, as in the
reference: `explore_stage` (dedupe, consult the artifact cache, and
coalesce every cache-miss request of one explore group into one batched
`explore_cells` run, or one `explore_cells_mesh` run on the device
mesh), `distill_stage` (requirements + layout buckets),
`layout_stage` (one bucket through `eda.batched_flow`) and
`finalize_stage` (per-request artifacts with provenance; fills the
artifact cache).  `run()` and `run_many()` drive them in order; the
pipelined `repro_torch.serve.design_service.DesignService` drives the
same stage functions from its stage threads and its layout pool, so the
two cannot diverge.  With a telemetry `recorder` attached, every stage
records `cat="session"` spans.

The session runs on `cuda` unless constructed with `device="cpu"`; with
no CUDA device and no device given it raises.  Island requests
(`islands > 1`) and sessions built with `mesh=` explore on the device
mesh (`repro_torch.parallel.distributed_explorer`); layout stays on the
session's `device`.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import tempfile
import time
from typing import Iterable

from repro_torch.api.request import DesignRequest
from repro_torch.core import nsga2
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.core.batched_explorer import explore_cells, sweep_program
from repro_torch.core.explorer import ParetoResult
from repro_torch.device import resolve_device
from repro_torch.eda.batched_flow import (BatchedLayoutResult,
                                          iter_layout_buckets)
from repro_torch.runtime.lock_sanitizer import make_lock

# The reference's artifact schema: port artifacts load with its
# `DesignArtifact.from_dict`, and each package's artifact cache serves
# the other's entries.
ARTIFACT_SCHEMA = 5


@dataclasses.dataclass(frozen=True)
class Provenance:
    """How an artifact was produced; the reference's fields, so the
    serialized artifact is interchangeable.  Wall-clock fields are this
    request's fair share of the shared work."""

    request_sha: str
    explore_s: float
    layout_s: float
    total_s: float
    new_traces: int             # always 0: the port traces nothing
    explorer_dispatches: int    # 0 when served from the front cache
    layout_dispatches: int
    front_cache_hit: bool
    coalesced: int
    served_from: str = "explorer"
    explore_wait_s: float = 0.0
    layout_wait_s: float = 0.0
    pipelined: bool = False
    attempts: int = 0
    retried_buckets: int = 0
    shed_buckets: int = 0
    worker_id: str = ""
    route_engine: str = ""      # the session's routing engine(s)
    route_rounds: int = 0       # scan: net slots; concurrent: rounds
    route_collisions: int = 0
    mesh_devices: int = 0
    islands: int = 1
    migration_topology: str = ""
    migration_rounds: int = 0


@dataclasses.dataclass(frozen=True, eq=False)
class DesignArtifact:
    """The result of one request: distilled front + layout rows +
    provenance (+ the in-memory layout tensors on the single-request
    path)."""

    request: DesignRequest
    pareto: ParetoResult
    layout_rows: tuple[dict, ...] | None
    provenance: Provenance
    layouts: BatchedLayoutResult | None = dataclasses.field(
        default=None, repr=False)
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None

    def summary(self) -> dict:
        """Provenance-free content view, for equality checks."""
        return {"array_size": self.pareto.array_size,
                "specs": [s.as_tuple() for s in self.pareto.specs],
                "front": self.pareto.to_rows(),
                "layout": (None if self.layout_rows is None
                           else list(self.layout_rows))}

    def to_dict(self) -> dict:
        return {"schema": ARTIFACT_SCHEMA,
                "request": self.request.to_dict(),
                "pareto": {"array_size": self.pareto.array_size,
                           "points": self.pareto.to_rows()},
                "layout_rows": (None if self.layout_rows is None
                                else list(self.layout_rows)),
                "provenance": dataclasses.asdict(self.provenance),
                "error": self.error}

    def to_json(self, path) -> None:
        """Atomic dump: a crash mid-write never leaves a truncated file
        at `path` (the persistent artifact cache depends on this)."""
        _atomic_dump(self.to_dict(), path)

    @classmethod
    def from_dict(cls, d: dict) -> "DesignArtifact":
        schema = d.get("schema", ARTIFACT_SCHEMA)
        if schema != ARTIFACT_SCHEMA:
            raise ValueError(f"artifact schema {schema} != supported "
                             f"{ARTIFACT_SCHEMA}; re-run the request")
        rows = d["layout_rows"]
        return cls(request=DesignRequest.from_dict(d["request"]),
                   pareto=ParetoResult.from_rows(d["pareto"]["array_size"],
                                                 d["pareto"]["points"]),
                   layout_rows=None if rows is None else tuple(rows),
                   provenance=Provenance(**d["provenance"]),
                   error=d.get("error"))

    @classmethod
    def from_json(cls, path) -> "DesignArtifact":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _atomic_dump(payload: dict, path) -> None:
    """Temp-file + `os.replace` JSON write: readers see the old or the
    new complete file, never a truncated one."""
    path = os.fspath(path)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# Bounded LRU memo of grid shapes, process-wide and shared by every
# session; hand-rolled (not lru_cache) so each lookup counts as a hit or
# miss of the *calling* session's stats.
GRID_SIG_CACHE_SIZE = 4096
_GRID_SIG_LOCK = make_lock("api.session._GRID_SIG_LOCK")
_GRID_SIG_MEMO: collections.OrderedDict = collections.OrderedDict()


def _grid_sig(spec: MacroSpec, coarse: int,
              session: "DesignSession | None" = None) -> tuple[int, int]:
    """Routing-grid shape of a spec's macro, without placing it.  With a
    `session`, the lookup counts as its "grid_sig_hits" / "_misses"."""
    key = (spec, coarse)
    with _GRID_SIG_LOCK:
        val = _GRID_SIG_MEMO.get(key)
        if val is not None:
            _GRID_SIG_MEMO.move_to_end(key)
    if val is not None:
        if session is not None:
            session.bump("grid_sig_hits")
        return val
    from repro_torch.eda.placer import geometry, layout_operands
    from repro_torch.eda.router import grid_shape

    ops = layout_operands(spec, geometry())
    val = grid_shape(ops.width, ops.height, coarse)
    with _GRID_SIG_LOCK:
        _GRID_SIG_MEMO[key] = val
        _GRID_SIG_MEMO.move_to_end(key)
        while len(_GRID_SIG_MEMO) > GRID_SIG_CACHE_SIZE:
            _GRID_SIG_MEMO.popitem(last=False)
    if session is not None:
        session.bump("grid_sig_misses")
    return val


def _bucket_key(spec: MacroSpec, coarse: int, capacity: int,
                session: "DesignSession | None" = None) -> tuple:
    """Layout-bucket key: the routing-grid shape quantized to the next
    power of two per axis (bounds padded-cell waste at <2x per axis)."""
    gh, gw = _grid_sig(spec, coarse, session)
    return (coarse, capacity,
            1 << (gh - 1).bit_length(), 1 << (gw - 1).bit_length())


# ----------------------------------------------------------------------
# Inter-stage payload types
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayoutBucket:
    """One unit of layout work: specs sharing a quantized grid shape
    (`request is None`) or one request's whole distilled set."""

    key: tuple
    coarse: int
    capacity: int
    specs: tuple[MacroSpec, ...]
    request: DesignRequest | None = None


@dataclasses.dataclass
class BucketResult:
    """`layout_stage`'s product for one bucket."""

    bucket: LayoutBucket
    rows: dict                        # MacroSpec -> metrics row
    elapsed_s: float
    result: BatchedLayoutResult | None = None   # whole-request buckets only
    queue_wait_s: float = 0.0         # stamped by the pipelined executor
    # stamped by the service's layout pool: which attempt produced this
    # result (1 = first try), whether a straggler watchdog shed the
    # bucket to a peer, and which pool worker completed it first
    attempts: int = 1
    shed: bool = False
    worker_id: str = ""
    engine: str = ""
    rounds: int = 0
    collisions: int = 0


@dataclasses.dataclass
class ExploredBatch:
    """`explore_stage` -> `distill_stage` payload."""

    requests: list                    # deduped cache-miss remainder, in order
    served: dict                      # DesignRequest -> DesignArtifact
    fronts: dict                      # DesignRequest -> ParetoResult
    info: dict                        # DesignRequest -> explore-info dict


@dataclasses.dataclass
class DistilledBatch:
    """`distill_stage` -> `layout_stage`/`finalize_stage` payload;
    `spec_keys[r]` names the bucket of each of `distilled[r].specs`."""

    explored: ExploredBatch
    distilled: dict                   # DesignRequest -> ParetoResult
    errors: dict                      # DesignRequest -> message
    buckets: list                     # [LayoutBucket], formation order
    spec_keys: dict                   # DesignRequest -> tuple[bucket key, ...]


class _SweepProgram:
    """One program-cache entry: the sweep for a shape signature."""

    def __init__(self, request: DesignRequest):
        self.statics = nsga2.EvolveStatics(
            pop_size=request.pop_size,
            crossover_prob=request.crossover_prob,
            mutation_prob=request.mutation_prob,
            use_pallas_dominance=request.use_pallas_dominance,
            use_pallas_rank=request.use_pallas_rank)
        self.n_gens = request.generations
        self.fn = functools.partial(sweep_program, statics=self.statics,
                                    n_gens=self.n_gens)


class DesignSession:
    """Long-lived request executor owning the program and front caches,
    optionally backed by a persistent cross-process artifact cache."""

    def __init__(self, *, artifact_cache=None, recorder=None, device=None,
                 route_engine: str | None = None, mesh=None):
        """`artifact_cache` is an `ArtifactCache`
        (`repro_torch.api.artifact_cache`; or anything with its
        `get(request)` / `put(artifact)` shape, such as a
        `TieredArtifactCache`), a directory path to open one at, or
        `None` for in-memory caches only.  `recorder` is an optional
        `repro_torch.telemetry.spans.SpanRecorder` for the stage spans.
        `device` is where explore and layout run: `None` -> `cuda`
        (raises without a CUDA device).  `route_engine` is the layout's
        routing engine when a call names none (`batched_flow
        .batched_route`: None or "scan", or "concurrent").

        `mesh` opts the explore stage onto the device-mesh engine
        (`distributed_explorer.explore_cells_mesh`): a sequence of device
        positions (`("cuda:0", "cuda:0")`, `("cpu",) * 4`), an int cap
        on the local CUDA devices, or `True` for all of them (with
        `device="cpu"`: the one CPU position).  Island requests
        (`DesignRequest.islands > 1`) take the mesh engine even when
        `mesh` is None; fronts do not depend on the mesh size.  The mesh
        is resolved at the first mesh dispatch; layout stays on
        `device`."""
        self.device = resolve_device(device)
        self.route_engine = route_engine
        self._programs: dict[tuple, _SweepProgram] = {}
        self._fronts: dict[tuple, ParetoResult] = {}
        self.recorder = recorder
        self.stats: collections.Counter = collections.Counter()
        # Every service thread (stage workers, layout pool, pump) writes
        # these counters, so all mutations go through bump() and all
        # snapshots copy under this lock.
        self.stats_lock = make_lock("DesignSession.stats_lock")
        if artifact_cache is not None and not hasattr(artifact_cache, "put"):
            from repro_torch.api.artifact_cache import ArtifactCache
            artifact_cache = ArtifactCache(artifact_cache)
        self.artifact_cache = artifact_cache
        self.mesh = mesh
        self._resolved_mesh = None

    def _mesh_for_dispatch(self) -> tuple:
        """The resolved mesh, a tuple of `torch.device` positions (built
        lazily, so sessions that never explore on the mesh never inspect
        devices; built again when `self.mesh` is set anew, as
        `DesignService(mesh=...)` does)."""
        knob = self.mesh
        if self._resolved_mesh is None or self._resolved_mesh[0] is not knob:
            from repro_torch.parallel import distributed_explorer as dx
            if knob is None or isinstance(knob, int):
                # None or True: every local device; an int: that many
                cap = None if knob is None or isinstance(knob, bool) else knob
                mesh = dx.default_mesh(max_devices=cap, device=self.device)
            else:
                mesh = dx.as_mesh(knob)
            self._resolved_mesh = (knob, mesh)
        return self._resolved_mesh[1]

    def bump(self, key: str, n: int = 1) -> None:
        """Increment a stats counter under `stats_lock`: the one
        mutation path for `self.stats`."""
        with self.stats_lock:
            self.stats[key] += n

    def _span(self, name: str, **tags):
        """A `cat="session"` telemetry span, or a no-op without a
        recorder."""
        if self.recorder is None:
            return contextlib.nullcontext()
        return self.recorder.span(name, cat="session", **tags)

    # -- program cache ---------------------------------------------------
    def program_for(self, request: DesignRequest) -> _SweepProgram:
        sig = request.shape_signature()
        prog = self._programs.get(sig)
        if prog is None:
            prog = self._programs[sig] = _SweepProgram(request)
            self.bump("program_cache_misses")
        else:
            self.bump("program_cache_hits")
        return prog

    # -- exploration (coalesced across requests) -------------------------
    def _fronts_for(self, requests: list[DesignRequest]):
        """Resolve every request's (undistilled) front; missing fronts of
        one explore group fold into one batched run."""
        info = {r: {"explore_s": 0.0, "new_traces": 0, "dispatches": 0,
                    "cache_hit": True, "coalesced": 1} for r in requests}
        pending: dict[tuple, list[DesignRequest]] = {}
        for r in requests:
            if r.explore_key() in self._fronts:
                self.bump("front_cache_hits")
            else:
                pending.setdefault(r.explore_group(), []).append(r)
        for group in pending.values():
            r0 = group[0]
            cells = list(dict.fromkeys(r.cell for r in group))
            t0 = time.perf_counter()
            facts: dict = {}
            if r0.islands > 1 or self.mesh is not None:
                from repro_torch.parallel import distributed_explorer as dx
                mesh = self._mesh_for_dispatch()
                with self._span("explore_dispatch", cells=len(cells),
                                coalesced=len(group), engine="mesh",
                                islands=r0.islands):
                    fronts, facts = dx.explore_cells_mesh(
                        cells, mesh=mesh, islands=r0.islands,
                        migrate_every=r0.migrate_every,
                        pop_size=r0.pop_size, generations=r0.generations,
                        crossover_prob=r0.crossover_prob,
                        mutation_prob=r0.mutation_prob, cal=r0.cal,
                        use_pallas_dominance=r0.use_pallas_dominance,
                        use_pallas_rank=r0.use_pallas_rank)
                self.bump("mesh_dispatches")
            else:
                prog = self.program_for(r0)
                with self._span("explore_dispatch", cells=len(cells),
                                coalesced=len(group)):
                    fronts = explore_cells(cells, cal=r0.cal,
                                           program=prog.fn,
                                           device=self.device)
            dt = time.perf_counter() - t0
            self.bump("explorer_dispatches")
            self.bump("run_cell_traces", 0)   # the port traces nothing
            for cell, front in fronts.items():
                self._fronts[r0.explore_group() + cell] = front
            for r in group:
                info[r] = {"explore_s": dt / len(group), "new_traces": 0,
                           "dispatches": 1, "cache_hit": False,
                           "coalesced": len(group), **facts}
        return {r: self._fronts[r.explore_key()] for r in requests}, info

    def fronts_for(self, requests: Iterable[DesignRequest]
                   ) -> dict[DesignRequest, ParetoResult]:
        """Coalesced exploration only (no distillation, no layout)."""
        fronts, _ = self._fronts_for(list(requests))
        return fronts

    # -- layout ----------------------------------------------------------
    def layout(self, specs, *, coarse: int = 64, capacity: int = 4,
               engine: str | None = None) -> BatchedLayoutResult:
        """One batched layout run for a spec set.  Safe to call from
        several layout-pool threads at once: the batched flow keeps no
        shared state, its kernels launch on the one default stream, and
        the stats counter is locked."""
        self.bump("layout_dispatches")
        if engine is None:
            engine = self.route_engine
        (res,) = iter_layout_buckets([(tuple(specs), coarse, capacity)],
                                     engine=engine, device=self.device)
        return res

    # -- the four stages --------------------------------------------------
    def explore_stage(self, requests: Iterable[DesignRequest]
                      ) -> ExploredBatch:
        """Stage 1 — dedupe, consult the persistent artifact cache, and
        fold every cache-miss request of one explore group into one
        batched exploration.

        Requests found in the artifact cache land in `.served` with
        provenance re-stamped (`served_from="artifact_cache"` or its
        tier, zero dispatches); the remainder carries its fronts and
        explore info."""
        all_requests = list(dict.fromkeys(requests))
        served: dict[DesignRequest, DesignArtifact] = {}
        if self.artifact_cache is not None:
            tiered = hasattr(self.artifact_cache, "get_with_tier")
            for r in all_requests:
                t0 = time.perf_counter()
                if tiered:
                    hit, tier = self.artifact_cache.get_with_tier(r)
                else:
                    hit, tier = self.artifact_cache.get(r), None
                if hit is None:
                    self.bump("artifact_cache_misses")
                    if tiered:
                        self.bump("artifact_cache_l1_misses")
                        self.bump("artifact_cache_l2_misses")
                    continue
                self.bump("artifact_cache_hits")
                source = "artifact_cache"
                if tier is not None:
                    source = f"artifact_cache_{tier}"
                    self.bump(f"artifact_cache_{tier}_hits")
                    if tier == "l2":
                        self.bump("artifact_cache_l1_misses")
                        self.bump("artifact_cache_promotions")
                prov = dataclasses.replace(
                    hit.provenance, explore_s=0.0, layout_s=0.0,
                    total_s=time.perf_counter() - t0, new_traces=0,
                    explorer_dispatches=0, layout_dispatches=0,
                    front_cache_hit=False, coalesced=1,
                    explore_wait_s=0.0, layout_wait_s=0.0, pipelined=False,
                    attempts=0, retried_buckets=0, shed_buckets=0,
                    worker_id="", route_engine="", route_rounds=0,
                    route_collisions=0, mesh_devices=0,
                    migration_topology="", migration_rounds=0,
                    served_from=source)
                served[r] = dataclasses.replace(hit, provenance=prov)
        remainder = [r for r in all_requests if r not in served]
        fronts, info = (self._fronts_for(remainder) if remainder
                        else ({}, {}))
        return ExploredBatch(requests=remainder, served=served,
                             fronts=fronts, info=info)

    def distill_stage(self, explored: ExploredBatch, *,
                      strict: bool = True, bucket_layouts: bool = True
                      ) -> DistilledBatch:
        """Stage 2 — apply each request's requirements and form the
        layout buckets (quantized grid-shape union, or one whole-request
        bucket each).  A request whose requirements remove every point
        raises under `strict`, else is recorded in `.errors`."""
        distilled: dict[DesignRequest, ParetoResult] = {}
        errors: dict[DesignRequest, str] = {}
        for r in explored.requests:
            d = (explored.fronts[r] if r.requirements.is_noop
                 else explored.fronts[r].filter(
                     **r.requirements.as_filter_kwargs()))
            if r.layout and not len(d):
                msg = (f"requirements {r.requirements} removed every Pareto "
                       f"point for request {r.sha()} "
                       f"(array_size={r.array_size}); relax them or set "
                       f"layout=False")
                if strict:
                    raise ValueError(msg)
                errors[r] = msg
            distilled[r] = d

        laid = [r for r in explored.requests
                if r.layout and r not in errors]
        buckets: list[LayoutBucket] = []
        spec_keys: dict[DesignRequest, tuple] = {}
        if bucket_layouts:
            members: dict[tuple, dict] = {}
            for r in laid:
                keys = []
                for spec in distilled[r].specs:
                    key = _bucket_key(spec, r.coarse, r.capacity, self)
                    members.setdefault(key, {})[spec] = None
                    keys.append(key)
                spec_keys[r] = tuple(keys)
            buckets = [LayoutBucket(key=k, coarse=k[0], capacity=k[1],
                                    specs=tuple(specs))
                       for k, specs in members.items()]
        else:
            for r in laid:
                key = ("request", r.sha())
                buckets.append(LayoutBucket(key=key, coarse=r.coarse,
                                            capacity=r.capacity,
                                            specs=distilled[r].specs,
                                            request=r))
                spec_keys[r] = tuple(key for _ in distilled[r].specs)
        return DistilledBatch(explored=explored, distilled=distilled,
                              errors=errors, buckets=buckets,
                              spec_keys=spec_keys)

    def layout_stage(self, bucket: LayoutBucket) -> BucketResult:
        """Stage 3 — one bucket through the batched flow."""
        t0 = time.perf_counter()
        with self._span("layout_bucket", bucket=bucket.key,
                        specs=len(bucket.specs)):
            res = self.layout(bucket.specs, coarse=bucket.coarse,
                              capacity=bucket.capacity)
        dt = time.perf_counter() - t0
        return BucketResult(bucket=bucket,
                            rows=dict(zip(res.specs, res.metrics_rows())),
                            elapsed_s=dt,
                            result=(res if bucket.request is not None
                                    else None),
                            engine=res.routing.engine,
                            rounds=int(res.routing.rounds),
                            collisions=int(res.routing.collisions))

    def finalize_stage(self, batch: DistilledBatch,
                       bucket_results: Iterable[BucketResult], *,
                       waits: dict | None = None, pipelined: bool = False,
                       failed: dict | None = None
                       ) -> dict[DesignRequest, DesignArtifact]:
        """Stage 4 — demux bucket rows back to per-request artifacts,
        stamp provenance (fair-share wall clock, queue waits), and fill
        the persistent artifact cache.

        `waits` maps request -> explore-queue wait seconds (the
        pipelined executor's measurement); layout queue waits ride in
        on each `BucketResult.queue_wait_s`.  `failed` maps bucket key
        -> `(message, attempts)` for buckets whose layout exhausted the
        service's retry budget: a request touching one completes with
        `artifact.error` set (its distilled front attached,
        `layout_rows` None), and error artifacts are never cached."""
        explored = batch.explored
        results = {br.bucket.key: br for br in bucket_results}
        waits = waits or {}
        failed = failed or {}
        out: dict[DesignRequest, DesignArtifact] = {}
        for r, art in explored.served.items():
            if pipelined:
                prov = dataclasses.replace(
                    art.provenance, pipelined=True,
                    explore_wait_s=waits.get(r, 0.0))
                art = dataclasses.replace(art, provenance=prov)
            out[r] = art
        for r in explored.requests:
            i = explored.info[r]
            keys = batch.spec_keys.get(r, ())
            uniq = list(dict.fromkeys(keys))
            bad = [k for k in uniq if k in failed]
            touched = [results[k] for k in uniq if k in results]
            layout_s = sum(results[k].elapsed_s / len(results[k].bucket.specs)
                           for k in keys if k in results)
            layout_wait = (sum(br.queue_wait_s for br in touched)
                           / len(touched) if touched else 0.0)
            rows_for = (tuple(results[k].rows[s] for k, s
                              in zip(keys, batch.distilled[r].specs))
                        if keys and not bad else None)
            layouts = next((br.result for br in touched
                            if br.bucket.request is r), None)
            error = batch.errors.get(r)
            if bad and error is None:
                error = (f"{len(bad)} of {len(uniq)} layout bucket(s) "
                         f"failed for request {r.sha()}: "
                         + "; ".join(failed[k][0] for k in bad))
            attempts = (sum(br.attempts for br in touched)
                        + sum(failed[k][1] for k in bad))
            retried = (sum(1 for br in touched if br.attempts > 1)
                       + sum(1 for k in bad if failed[k][1] > 1))
            prov = Provenance(
                request_sha=r.sha(), explore_s=i["explore_s"],
                layout_s=layout_s, total_s=i["explore_s"] + layout_s,
                new_traces=0, explorer_dispatches=i["dispatches"],
                layout_dispatches=len(touched),
                front_cache_hit=i["cache_hit"], coalesced=i["coalesced"],
                served_from=("front_cache" if i["cache_hit"]
                             else "explorer"),
                explore_wait_s=waits.get(r, 0.0),
                layout_wait_s=layout_wait, pipelined=pipelined,
                attempts=attempts, retried_buckets=retried,
                shed_buckets=sum(1 for br in touched if br.shed),
                worker_id=(touched[0].worker_id if touched else ""),
                route_engine="/".join(sorted({br.engine for br in touched
                                              if br.engine})),
                route_rounds=sum(br.rounds for br in touched),
                route_collisions=sum(br.collisions for br in touched),
                mesh_devices=i.get("mesh_devices", 0),
                islands=i.get("islands", r.islands),
                migration_topology=i.get("migration_topology", ""),
                migration_rounds=i.get("migration_rounds", 0))
            art = DesignArtifact(request=r, pareto=batch.distilled[r],
                                 layout_rows=rows_for, provenance=prov,
                                 layouts=layouts, error=error)
            if self.artifact_cache is not None and art.ok:
                self.artifact_cache.put(art)
                self.bump("artifact_cache_writes")
                if hasattr(self.artifact_cache, "get_with_tier"):
                    self.bump("artifact_cache_l2_writes")
            out[r] = art
        self.bump("requests_served", len(out))
        return out

    def error_artifact(self, request: DesignRequest, message: str, *,
                       pipelined: bool = False,
                       explore_wait_s: float = 0.0) -> DesignArtifact:
        """A terminal failure artifact: an empty frontier, no layouts,
        `error` set, `provenance.served_from == "error"`.  The pipelined
        service makes these when a whole batch stage (explore / distill
        / finalize) exhausts its retry budget.  Never written to the
        persistent cache (`art.ok` is False)."""
        prov = Provenance(
            request_sha=request.sha(), explore_s=0.0, layout_s=0.0,
            total_s=0.0, new_traces=0, explorer_dispatches=0,
            layout_dispatches=0, front_cache_hit=False, coalesced=1,
            served_from="error", explore_wait_s=explore_wait_s,
            pipelined=pipelined)
        return DesignArtifact(
            request=request,
            pareto=ParetoResult.from_rows(request.array_size, []),
            layout_rows=None, provenance=prov, error=message)

    # -- the end-to-end drivers -------------------------------------------
    def run_many(self, requests: Iterable[DesignRequest], *,
                 bucket_layouts: bool = True, strict: bool = True
                 ) -> dict[DesignRequest, DesignArtifact]:
        """Execute a request batch through the four stages: one
        coalesced exploration per explore group, then bucketed (or
        per-request) layout, demuxed into per-request artifacts.

        A request whose requirements remove every Pareto point raises
        `ValueError` under `strict=True`; under `strict=False` (the
        multi-tenant path) it gets an artifact with `error` set and the
        rest of the batch is served.  Requests found in the artifact
        cache are served from it (zero dispatches); the rest are written
        back."""
        explored = self.explore_stage(requests)
        with self._span("distill", requests=len(explored.requests)):
            batch = self.distill_stage(explored, strict=strict,
                                       bucket_layouts=bucket_layouts)
        results = [self.layout_stage(b) for b in batch.buckets]
        with self._span("finalize", buckets=len(results)):
            return self.finalize_stage(batch, results)

    def run(self, request: DesignRequest) -> DesignArtifact:
        """Execute one request end to end (one layout batch, so the
        artifact also carries the `BatchedLayoutResult`, unless it was
        served from the artifact cache, which keeps only `layout_rows`)."""
        return self.run_many([request], bucket_layouts=False)[request]
