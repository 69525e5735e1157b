"""The golden layout rows the port is held to on the card.

`src/repro_torch/_golden/layout_rows_16384.json` holds, for every spec
of the exhaustive Pareto front of the 16 kb macro, the reference's
objectives and its `generate_layouts` metrics row (concurrent engine).
`chip_smoke.py` checks the port's `DesignSession.run` against it on the
GPU, where there is no JAX.  This test regenerates the file from the
reference and asserts it is unchanged; run this module as a script to
rewrite it:

    PYTHONPATH=src python tests/test_torch_golden.py
"""
import json
import pathlib
import sys

import numpy as np

from repro.core import explorer, pareto
from repro.core.acim_spec import MacroSpec
from repro.eda import batched_flow

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "_golden" / "layout_rows_16384.json")
ARRAY_SIZE = 16384


def golden_document() -> dict:
    genes, objs = explorer.full_design_space(ARRAY_SIZE)
    genes, objs = np.asarray(genes), np.asarray(objs)
    front = np.asarray(pareto.non_dominated_mask(objs))
    specs = [MacroSpec(2 ** int(h), ARRAY_SIZE // 2 ** int(h), 2 ** int(l),
                       int(b)) for h, l, b in genes[front]]
    rows = batched_flow.generate_layouts(
        specs, coarse=64, capacity=4, engine="concurrent").metrics_rows()
    points = [{"key": [s.h, s.l, s.b_adc],
               "objectives": [float(v) for v in o],
               "row": row}
              for s, o, row in zip(specs, objs[front], rows)]
    points.sort(key=lambda p: p["key"])
    return {"array_size": ARRAY_SIZE, "coarse": 64, "capacity": 4,
            "source": "repro.eda.batched_flow.generate_layouts(engine="
                      "'concurrent') over the exhaustive Pareto front of "
                      "repro.core.explorer.full_design_space(16384)",
            "points": points}


def test_golden_rows_match_reference():
    assert json.loads(GOLDEN.read_text()) == golden_document()


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(golden_document(), indent=1) + "\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
