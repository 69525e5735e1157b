"""Declarative design queries: the one request type for the whole flow.

Counterpart of `repro.api.request`, with the same fields, the same
`to_dict` / `from_dict` and the same `sha()`, so a request hashes to
the same key in both packages and a port artifact's request loads in
the reference.

Two derived keys organize the caching and coalescing:

  * `shape_signature()` — the structural part of the request
    (population size, generation count, probabilities, kernel
    selection, island settings); requests sharing it share one sweep
    program entry;
  * `explore_key()` — the full exploration identity (signature + cell
    + calibration).  Two requests with equal explore keys have equal
    Pareto fronts, so the session caches fronts under it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math

from repro_torch.core.constants import CAL28, CalibConstants
from repro_torch.core.nsga2 import DEFAULT_CROSSOVER_PROB, DEFAULT_MUTATION_PROB


@dataclasses.dataclass(frozen=True)
class Requirements:
    """Application requirements: the agile-distillation thresholds
    (paper Fig. 4, arrow 'remove undesired solutions')."""

    min_snr_db: float = float("-inf")
    min_tops: float = 0.0
    max_energy_fj: float = float("inf")
    max_area: float = float("inf")
    min_tops_per_w: float = 0.0

    @property
    def is_noop(self) -> bool:
        return self == Requirements()

    def as_filter_kwargs(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DesignRequest:
    """One end-to-end design query (explore -> distill -> layout)."""

    array_size: int
    seed: int = 0
    # MOGA budget
    pop_size: int = 256
    generations: int = 80
    crossover_prob: float = DEFAULT_CROSSOVER_PROB
    mutation_prob: float = DEFAULT_MUTATION_PROB
    # technology calibration
    cal: CalibConstants = CAL28
    # kernel selection (on CUDA: see repro_torch.core.nsga2.rank_and_crowd)
    use_pallas_dominance: bool = False
    use_pallas_rank: bool = False
    # island-model mesh exploration: kept so requests and their hashes
    # match the reference's; the port's session runs islands == 1 only.
    islands: int = 1
    migrate_every: int = 20
    # application requirements (agile distillation)
    requirements: Requirements = Requirements()
    # layout options
    layout: bool = True
    coarse: int = 64
    capacity: int = 4

    def __post_init__(self) -> None:
        s = self.array_size
        if s <= 0 or (s & (s - 1)) != 0:
            raise ValueError(f"array_size must be a positive power of two, "
                             f"got {s}")
        if self.pop_size <= 0 or self.generations <= 0:
            raise ValueError("pop_size and generations must be positive")
        if self.coarse <= 0 or self.capacity <= 0:
            raise ValueError("coarse and capacity must be positive")
        if self.islands <= 0 or self.migrate_every <= 0:
            raise ValueError("islands and migrate_every must be positive")

    # -- derived keys ---------------------------------------------------
    def shape_signature(self) -> tuple:
        """Structural part: requests sharing it share one sweep program."""
        return (self.pop_size, self.generations, self.crossover_prob,
                self.mutation_prob, self.use_pallas_dominance,
                self.use_pallas_rank, self.islands, self.migrate_every)

    def explore_group(self) -> tuple:
        """Requests sharing this can be coalesced into one dispatch."""
        return self.shape_signature() + (self.cal,)

    def explore_key(self) -> tuple:
        """Full exploration identity: equal keys -> bit-equal fronts."""
        return self.explore_group() + (self.array_size, self.seed)

    @property
    def cell(self) -> tuple[int, int]:
        return (self.array_size, self.seed)

    # -- (de)serialization ----------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["requirements"] = _finite_dict(d["requirements"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DesignRequest":
        d = dict(d)
        # a clear diagnosis beats dataclass __init__'s TypeError when an
        # artifact-cache entry was written by a newer request schema
        unknown = sorted(set(d) - {f.name for f in dataclasses.fields(cls)})
        if unknown:
            raise ValueError(f"unknown DesignRequest field(s) {unknown} — "
                             f"written by a newer schema?")
        d["cal"] = CalibConstants(**d["cal"])
        d["requirements"] = Requirements(**_definite_dict(d["requirements"]))
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "DesignRequest":
        return cls.from_dict(json.loads(text))

    def sha(self) -> str:
        """Stable content hash (provenance / cache keys across processes)."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]


def _finite_dict(d: dict) -> dict:
    """+/-inf thresholds -> "inf"/"-inf" strings, for strict-JSON
    interchange.  Signed string markers (not null) so a request that
    *excludes* everything (`min_tops=inf`) stays distinct from the
    all-pass defaults after a round trip."""
    return {k: (("-inf" if v < 0 else "inf")
                if isinstance(v, float) and math.isinf(v) else v)
            for k, v in d.items()}


def _definite_dict(d: dict) -> dict:
    """Invert `_finite_dict`."""
    return {k: (float(v) if v in ("inf", "-inf") else v)
            for k, v in d.items()}
