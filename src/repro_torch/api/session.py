"""Design sessions: long-lived, cache-owning request execution on the card.

Counterpart of `repro.api.session`.  `DesignSession` runs a
`DesignRequest` end to end (paper Fig. 4: explore -> distill -> layout)
and owns two caches:

  * a *program cache* keyed by `DesignRequest.shape_signature()` — one
    sweep-program entry per signature (the port compiles nothing, so
    `Provenance.new_traces` is always 0);
  * a *front cache* keyed by `DesignRequest.explore_key()` — the
    distillation-independent Pareto front, so a repeat query costs no
    exploration at all.

Execution is four stages with explicit payload types, as in the
reference: `explore_stage` (coalesce every cache-miss request of one
explore group into one batched `explore_cells` run), `distill_stage`
(requirements + layout buckets), `layout_stage` (one bucket through
`eda.batched_flow`) and `finalize_stage` (per-request artifacts with
provenance).  `run()` and `run_many()` drive them in order.

The session runs on `cuda` unless constructed with `device="cpu"`; with
no CUDA device and no device given it raises.  The reference's
persistent artifact cache, device mesh and telemetry recorder are not
ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import os
import tempfile
import threading
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

# The reference's artifact schema: port artifacts load with its
# `DesignArtifact.from_dict`.
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
    route_engine: str = ""      # "scan" for every laid-out request
    route_rounds: int = 0       # net slots routed
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


@functools.lru_cache(maxsize=4096)
def _grid_sig(spec: MacroSpec, coarse: int) -> tuple[int, int]:
    """Routing-grid shape of a spec's macro, without placing it."""
    from repro_torch.eda.placer import geometry, layout_operands
    from repro_torch.eda.router import grid_shape

    ops = layout_operands(spec, geometry())
    return grid_shape(ops.width, ops.height, coarse)


def _bucket_key(spec: MacroSpec, coarse: int, capacity: int) -> tuple:
    """Layout-bucket key: the routing-grid shape quantized to the next
    power of two per axis (bounds padded-cell waste at <2x per axis)."""
    gh, gw = _grid_sig(spec, coarse)
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
    engine: str = ""
    rounds: int = 0
    collisions: int = 0


@dataclasses.dataclass
class ExploredBatch:
    """`explore_stage` -> `distill_stage` payload."""

    requests: list                    # deduped requests, in order
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
    """Long-lived request executor owning the program and front caches."""

    def __init__(self, *, device=None):
        self.device = resolve_device(device)
        self._programs: dict[tuple, _SweepProgram] = {}
        self._fronts: dict[tuple, ParetoResult] = {}
        self.stats: collections.Counter = collections.Counter()
        self.stats_lock = threading.Lock()

    def bump(self, key: str, n: int = 1) -> None:
        """Increment a stats counter under `stats_lock`."""
        with self.stats_lock:
            self.stats[key] += n

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
            if r0.islands > 1:
                raise NotImplementedError(
                    "island (mesh) exploration is not ported yet")
            cells = list(dict.fromkeys(r.cell for r in group))
            prog = self.program_for(r0)
            t0 = time.perf_counter()
            fronts = explore_cells(cells, cal=r0.cal, program=prog.fn,
                                   device=self.device)
            dt = time.perf_counter() - t0
            self.bump("explorer_dispatches")
            for cell, front in fronts.items():
                self._fronts[r0.explore_group() + cell] = front
            for r in group:
                info[r] = {"explore_s": dt / len(group), "new_traces": 0,
                           "dispatches": 1, "cache_hit": False,
                           "coalesced": len(group)}
        return {r: self._fronts[r.explore_key()] for r in requests}, info

    def fronts_for(self, requests: Iterable[DesignRequest]
                   ) -> dict[DesignRequest, ParetoResult]:
        """Coalesced exploration only (no distillation, no layout)."""
        fronts, _ = self._fronts_for(list(requests))
        return fronts

    # -- layout ----------------------------------------------------------
    def layout(self, specs, *, coarse: int = 64, capacity: int = 4,
               engine: str | None = None) -> BatchedLayoutResult:
        """One batched layout run for a spec set."""
        self.bump("layout_dispatches")
        (res,) = iter_layout_buckets([(tuple(specs), coarse, capacity)],
                                     engine=engine, device=self.device)
        return res

    # -- the four stages --------------------------------------------------
    def explore_stage(self, requests: Iterable[DesignRequest]
                      ) -> ExploredBatch:
        """Stage 1 — dedupe and fold every request of one explore group
        into one batched exploration."""
        reqs = list(dict.fromkeys(requests))
        fronts, info = self._fronts_for(reqs) if reqs else ({}, {})
        return ExploredBatch(requests=reqs, fronts=fronts, info=info)

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
                    key = _bucket_key(spec, r.coarse, r.capacity)
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
                       bucket_results: Iterable[BucketResult]
                       ) -> dict[DesignRequest, DesignArtifact]:
        """Stage 4 — demux bucket rows back to per-request artifacts and
        stamp provenance (fair-share wall clock)."""
        explored = batch.explored
        results = {br.bucket.key: br for br in bucket_results}
        out: dict[DesignRequest, DesignArtifact] = {}
        for r in explored.requests:
            i = explored.info[r]
            keys = batch.spec_keys.get(r, ())
            uniq = list(dict.fromkeys(keys))
            touched = [results[k] for k in uniq if k in results]
            layout_s = sum(results[k].elapsed_s / len(results[k].bucket.specs)
                           for k in keys if k in results)
            rows_for = (tuple(results[k].rows[s] for k, s
                              in zip(keys, batch.distilled[r].specs))
                        if keys else None)
            layouts = next((br.result for br in touched
                            if br.bucket.request is r), None)
            prov = Provenance(
                request_sha=r.sha(), explore_s=i["explore_s"],
                layout_s=layout_s, total_s=i["explore_s"] + layout_s,
                new_traces=0, explorer_dispatches=i["dispatches"],
                layout_dispatches=len(touched),
                front_cache_hit=i["cache_hit"], coalesced=i["coalesced"],
                served_from=("front_cache" if i["cache_hit"]
                             else "explorer"),
                attempts=len(touched),
                route_engine="/".join(sorted({br.engine for br in touched
                                              if br.engine})),
                route_rounds=sum(br.rounds for br in touched),
                route_collisions=sum(br.collisions for br in touched),
                islands=r.islands)
            out[r] = DesignArtifact(request=r, pareto=batch.distilled[r],
                                    layout_rows=rows_for, provenance=prov,
                                    layouts=layouts,
                                    error=batch.errors.get(r))
        self.bump("requests_served", len(out))
        return out

    # -- the end-to-end drivers -------------------------------------------
    def run_many(self, requests: Iterable[DesignRequest], *,
                 bucket_layouts: bool = True, strict: bool = True
                 ) -> dict[DesignRequest, DesignArtifact]:
        """Execute a request batch through the four stages: one
        coalesced exploration per explore group, then bucketed (or
        per-request) layout, demuxed into per-request artifacts."""
        explored = self.explore_stage(requests)
        batch = self.distill_stage(explored, strict=strict,
                                   bucket_layouts=bucket_layouts)
        results = [self.layout_stage(b) for b in batch.buckets]
        return self.finalize_stage(batch, results)

    def run(self, request: DesignRequest) -> DesignArtifact:
        """Execute one request end to end (one layout batch, so the
        artifact also carries the `BatchedLayoutResult`)."""
        return self.run_many([request], bucket_layouts=False)[request]
