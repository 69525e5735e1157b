"""MOGA-based design-space explorer (paper Sec. 3.2) with agile filtering.

Counterpart of `repro.core.explorer`: `ParetoResult` (the deduplicated
Pareto set with objective metrics, `filter` (the paper's agile
distillation), `best`, and its rows / JSON round trip), the
distillation of a final population into one, and the exhaustive
`full_design_space` used as ground truth.

The supported way to drive the flow is `repro_torch.api`
(`DesignRequest` / `DesignSession` / the multi-tenant
`repro_torch.serve.design_service.DesignService`).  `explore()`,
`explore_sizes()` and `distill_and_layout()` below are the reference's
deprecation shims over it, kept for source compatibility; each takes a
keyword-only `device` (`cuda` when None) and runs on the process-wide
`repro_torch.api.default_session` of that device.
"""
from __future__ import annotations

import dataclasses
import json
import warnings

import numpy as np
import torch

from repro_torch.core import estimator, nsga2, pareto
from repro_torch.core.acim_spec import MacroSpec
from repro_torch.core.constants import CAL28, CalibConstants


@dataclasses.dataclass(frozen=True)
class ParetoResult:
    array_size: int
    specs: tuple[MacroSpec, ...]          # deduplicated Pareto-frontier set
    metrics: dict                          # name -> np.ndarray aligned w/ specs

    def __len__(self) -> int:
        return len(self.specs)

    def filter(self, *, min_snr_db: float = -np.inf, min_tops: float = 0.0,
               max_energy_fj: float = np.inf, max_area: float = np.inf,
               min_tops_per_w: float = 0.0) -> "ParetoResult":
        """Agile user distillation of the Pareto set (paper Fig. 4)."""
        if not self.specs:
            raise ValueError(
                "cannot filter an empty Pareto frontier (an earlier filter "
                "already removed every solution)")
        m = self.metrics
        keep = ((m["snr_db"] >= min_snr_db) & (m["tops"] >= min_tops)
                & (m["energy_fj_per_mac"] <= max_energy_fj)
                & (m["area_f2_per_bit"] <= max_area)
                & (m["tops_per_w"] >= min_tops_per_w))
        idx = np.nonzero(keep)[0]
        return ParetoResult(
            self.array_size,
            tuple(self.specs[i] for i in idx),
            {k: v[idx] for k, v in m.items()},
        )

    def best(self, metric: str, maximize: bool = True) -> MacroSpec:
        if not self.specs:
            raise ValueError(
                f"cannot select best({metric!r}) from an empty Pareto "
                f"frontier; relax the filter requirements")
        v = self.metrics[metric]
        i = int(np.argmax(v) if maximize else np.argmin(v))
        return self.specs[i]

    def to_rows(self) -> list[dict]:
        rows = []
        for i, s in enumerate(self.specs):
            row = {"h": s.h, "w": s.w, "l": s.l, "b_adc": s.b_adc}
            row.update({k: float(v[i]) for k, v in self.metrics.items()})
            rows.append(row)
        return rows

    @classmethod
    def from_rows(cls, array_size: int, rows: list[dict]) -> "ParetoResult":
        """Rebuild from `to_rows()` output (metrics come back float64)."""
        spec_keys = ("h", "w", "l", "b_adc")
        specs = tuple(MacroSpec(*(int(r[k]) for k in spec_keys))
                      for r in rows)
        metric_keys = [k for k in (rows[0] if rows else {})
                       if k not in spec_keys]
        metrics = {k: np.array([r[k] for r in rows]) for k in metric_keys}
        return cls(int(array_size), specs, metrics)

    def to_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump({"array_size": self.array_size,
                       "points": self.to_rows()}, f, indent=1)

    @classmethod
    def from_json(cls, path) -> "ParetoResult":
        """Inverse of `to_json`: load a frontier back from disk."""
        with open(path) as f:
            d = json.load(f)
        return cls.from_rows(d["array_size"], d["points"])


def _dedup_pareto(genes: np.ndarray, objs: np.ndarray):
    """Unique genes restricted to the non-dominated set."""
    uniq, idx = np.unique(genes, axis=0, return_index=True)
    objs_u = objs[idx]
    mask = pareto.non_dominated_mask(torch.from_numpy(objs_u)).numpy()
    return uniq[mask], objs_u[mask]


def pareto_result_from_population(array_size: int, genes: np.ndarray,
                                  objs: np.ndarray,
                                  cal: CalibConstants = CAL28) -> ParetoResult:
    """Distill a final NSGA-II population (host arrays) into a
    `ParetoResult`."""
    genes, _ = _dedup_pareto(np.asarray(genes), np.asarray(objs))
    h = (2 ** genes[:, 0]).astype(np.int64)
    w = (array_size // h).astype(np.int64)
    l = (2 ** genes[:, 1]).astype(np.int64)
    b = genes[:, 2].astype(np.int64)
    specs = tuple(MacroSpec(int(hh), int(ww), int(ll), int(bb))
                  for hh, ww, ll, bb in zip(h, w, l, b))
    rep = estimator.evaluate_report(h.astype(np.float32), w.astype(np.float32),
                                    l.astype(np.float32), b.astype(np.float32),
                                    cal)
    metrics = {k: v.numpy() for k, v in rep.items()}
    return ParetoResult(array_size, specs, metrics)


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.core.explorer.{old} is deprecated; use {new} "
        f"(see docs/api.md)", DeprecationWarning, stacklevel=3)


def explore(array_size: int, *, pop_size: int = 256, generations: int = 80,
            seed: int = 0, cal: CalibConstants = CAL28,
            use_pallas_dominance: bool = False,
            use_pallas_rank: bool = False, device=None) -> ParetoResult:
    """Deprecated shim over `repro_torch.api`: run the MOGA explorer for
    one array size and return the (undistilled) `ParetoResult`.

    Use `DesignSession().run(DesignRequest(array_size, layout=False))`
    instead; repeated shim calls share the default session's program and
    front caches."""
    from repro_torch.api import DesignRequest, default_session

    _deprecated("explore", "repro_torch.api.DesignSession.run")
    req = DesignRequest(array_size=array_size, seed=seed, pop_size=pop_size,
                        generations=generations, cal=cal,
                        use_pallas_dominance=use_pallas_dominance,
                        use_pallas_rank=use_pallas_rank, layout=False)
    return default_session(device=device).run(req).pareto


def explore_sizes(sizes=(4096, 16384, 65536), *, seed: int = 0,
                  device=None, **kw) -> dict[int, ParetoResult]:
    """Deprecated shim over `repro_torch.api`: Fig. 9(a)(b)-style sweep
    over array sizes, coalesced by a `DesignService` into one explore
    dispatch for the whole sweep."""
    from repro_torch.api import DesignRequest, default_session
    from repro_torch.serve.design_service import DesignService

    _deprecated("explore_sizes",
                "repro_torch.serve.design_service.DesignService")
    sizes = tuple(sizes)
    svc = DesignService(session=default_session(device=device),
                        max_coalesce=max(len(sizes), 1))
    tickets = {int(s): svc.submit(DesignRequest(
        array_size=int(s), seed=seed, layout=False, **kw)) for s in sizes}
    arts = svc.run()
    return {s: arts[tickets[int(s)]].pareto for s in sizes}


def distill_and_layout(array_size: int, *, pop_size: int = 256,
                       generations: int = 80, seed: int = 0,
                       cal: CalibConstants = CAL28, coarse: int = 64,
                       capacity: int = 4, use_pallas_dominance: bool = False,
                       use_pallas_rank: bool = False, device=None,
                       **filter_kw):
    """Deprecated shim over `repro_torch.api`: MOGA sweep -> agile
    distillation -> batched layout generation (paper Fig. 4 end to end).

    `filter_kw` are `ParetoResult.filter` thresholds (the
    `repro_torch.api.Requirements` fields).  Returns `(distilled,
    layouts)` as `DesignSession.run(...)`'s artifact carries them."""
    from repro_torch.api import DesignRequest, Requirements, default_session

    _deprecated("distill_and_layout", "repro_torch.api.DesignSession.run")
    req = DesignRequest(array_size=array_size, seed=seed, pop_size=pop_size,
                        generations=generations, cal=cal,
                        use_pallas_dominance=use_pallas_dominance,
                        use_pallas_rank=use_pallas_rank,
                        requirements=Requirements(**filter_kw),
                        coarse=coarse, capacity=capacity, layout=True)
    artifact = default_session(device=device).run(req)
    return artifact.pareto, artifact.layouts


def full_design_space(array_size: int, cal: CalibConstants = CAL28):
    """Exhaustive enumeration of the feasible (power-of-two) space:
    ((N, 3) int32 genes, (N, 4) float32 objectives) on the CPU."""
    cfg = nsga2.NSGA2Config(array_size=array_size, cal=cal)
    h_lo, h_hi = cfg.h_exp_bounds
    l_lo, l_hi = cfg.l_exp_bounds
    b_lo, b_hi = cfg.b_bounds
    pts = [(he, le, b)
           for he in range(h_lo, h_hi + 1)
           for le in range(l_lo, min(l_hi, he) + 1)
           for b in range(b_lo, min(b_hi, he - le) + 1)]
    genes = torch.tensor(pts, dtype=torch.int32)
    return genes, nsga2.evaluate(genes, cfg)
