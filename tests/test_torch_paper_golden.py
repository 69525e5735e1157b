"""The golden paper rows the port's drivers are held to on the card.

`src/repro_torch/_golden/paper_rows.json` holds what the reference's
drivers (`benchmarks/`) give at their own budgets, without clocks:
Fig. 8's rows (the sequential layout flow), the exhaustive Pareto front
of each of Fig. 9's and Fig. 10's sizes (`full_design_space`, whose
fronts every explored front must lie inside), Fig. 9's trend dict,
Fig. 10's span and SOTA flags of the reference's own run and of the
exhaustive fronts pooled, and `snr_mc`'s analytic column.
`chip_smoke.py` reads it on the GPU, where there is no JAX.  This test
regenerates the file from the reference and asserts it is unchanged;
run this module as a script to rewrite it:

    PYTHONPATH=src:. python tests/test_torch_paper_golden.py
"""
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np

from benchmarks import fig8_layouts, fig9_design_space, fig10_sota, snr_mc
from repro.core import estimator, explorer, pareto

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "_golden" / "paper_rows.json")
SIZES = (4096, 16384, 65536)


def exhaustive_front(size: int) -> list[dict]:
    """The rows (`ParetoResult.to_rows`) of `size`'s exhaustive front."""
    genes, objs = explorer.full_design_space(size)
    genes, objs = np.asarray(genes), np.asarray(objs)
    front = np.asarray(pareto.non_dominated_mask(objs))
    return explorer.pareto_result_from_population(
        size, genes[front], objs[front]).to_rows()


def fig10_of(fronts: list[list[dict]]) -> dict:
    """`fig10_sota.run`'s dict of the pooled rows of `fronts`."""
    ee = np.array([r["tops_per_w"] for f in fronts for r in f])
    area = np.array([r["area_f2_per_bit"] for f in fronts for r in f])
    lo_e, hi_e = fig10_sota.PAPER_EE_RANGE
    lo_a, hi_a = fig10_sota.PAPER_AREA_RANGE
    front = np.asarray(pareto.non_dominated_mask(
        jnp.stack([-jnp.asarray(ee), jnp.asarray(area)], axis=-1)))
    return {
        "ee_min": float(ee.min()), "ee_max": float(ee.max()),
        "area_min": float(area.min()), "area_max": float(area.max()),
        "ee_span_covers_paper": bool(ee.min() <= lo_e * 1.2
                                     and ee.max() >= hi_e * 0.8),
        "area_span_covers_paper": bool(area.min() <= lo_a * 1.2
                                       and area.max() >= hi_a * 0.8),
        "n_front": int(front.sum()),
        "sota_matched": {label: bool(np.any((ee >= e) & (area <= a)))
                         for label, e, a in fig10_sota.SOTA}}


def golden_document() -> dict:
    fronts = {str(s): exhaustive_front(s) for s in SIZES}
    return {
        "source": "the reference's drivers under benchmarks/ at their own "
                  "budgets; exhaustive fronts of repro.core.explorer"
                  ".full_design_space",
        "fig8": [{k: v for k, v in r.items() if k != "layout_seconds"}
                 for r in fig8_layouts.run()],
        "fronts": fronts,
        "fig9_trends": fig9_design_space.trend_checks(),
        "fig10": {"reference_run": fig10_sota.run(),
                  "exhaustive": fig10_of(list(fronts.values()))},
        "snr_analytic": [[h, l, b, float(estimator.snr_total_db(h, l, b))]
                         for h, l, b in snr_mc.POINTS],
    }


def test_golden_paper_rows_match_reference():
    assert json.loads(GOLDEN.read_text()) == golden_document()


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(golden_document(), indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
