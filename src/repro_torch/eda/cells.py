"""Customized cell library (paper Fig. 4 input: "customized cell library").

Each template cell is an opaque, manually-designed layout (the paper's
"Std layout cell"): a footprint in grid units (1 unit = 1 F, feature size)
plus named pin offsets.  Footprints are derived from the calibrated area
constants so the generated layout's F^2/bit accounting is consistent with
the estimation model (Eq. 10) — the benchmark asserts this.

A copy of `repro.eda.cells`: the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.constants import CAL28, CalibConstants


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    width: int                      # grid units (F)
    height: int
    pins: tuple[tuple[str, int, int], ...]   # (pin, dx, dy)

    @property
    def area(self) -> int:
        return self.width * self.height


def _mk(name: str, area_f2: float, aspect: float, pins: tuple[str, ...]) -> Cell:
    w = max(2, int(round(math.sqrt(area_f2 * aspect))))
    h = max(2, int(round(area_f2 / w)))
    # pins distributed along the top edge
    pin_t = tuple((p, min(w - 1, 1 + i * max(1, w // max(len(pins), 1))), h - 1)
                  for i, p in enumerate(pins))
    return Cell(name, w, h, pin_t)


def library(cal: CalibConstants = CAL28) -> dict[str, Cell]:
    """The ACIM component cells (paper Sec. 3: 8T SRAM, local-array cap
    cell, comparator(+column periphery), DFF, RBL switch, row driver)."""
    return {
        "SRAM8T": _mk("SRAM8T", cal.a_sram, 1.3, ("WL", "RWL", "BL", "BLB", "RBL")),
        "CAPLC": _mk("CAPLC", cal.a_lc, 1.0, ("TOP", "BOT", "RST", "CTRL")),
        "COMP": _mk("COMP", cal.a_comp * 0.25, 2.0, ("INP", "INN", "CLK", "OUT")),
        "SARLOGIC": _mk("SARLOGIC", cal.a_comp * 0.75, 3.0,
                        ("CMP", "CLK", "P", "N", "DOUT")),
        "DFF": _mk("DFF", cal.a_dff, 1.5, ("D", "CLK", "Q")),
        "RBLSW": _mk("RBLSW", cal.a_dff * 0.2, 1.0, ("A", "B", "EN")),
        "ROWDRV": _mk("ROWDRV", 420.0, 0.5, ("IN", "OUT")),
    }
