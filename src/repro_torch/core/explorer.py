"""Pareto-front results of the MOGA explorer and the agile filter.

Counterpart of `repro.core.explorer` (the parts the session path uses):
`ParetoResult` (the deduplicated Pareto set with objective metrics and
`filter`, the paper's agile distillation), the distillation of a final
population into one, and the exhaustive `full_design_space` used as
ground truth.
"""
from __future__ import annotations

import dataclasses

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
