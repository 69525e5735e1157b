"""Layout-flow result types shared with the batched flow.

Counterpart of `repro.eda.flow`'s `DRCReport`; the single-spec
sequential flow is not ported yet.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DRCReport:
    overlaps: int
    out_of_bounds: int

    @property
    def clean(self) -> bool:
        return self.overlaps == 0 and self.out_of_bounds == 0
