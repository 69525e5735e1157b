"""ACIM macro design-point spec (the paper's decision vector).

A design point is (H, W, L, B_ADC) under the Eq. 12 constraints:
    H * W == array_size          (user-given array size)
    H >= L                       (local array fits in a column)
    H / L >= 2**B_ADC            (CDAC needs 1:1:2:...:2^(B-1) cap groups)
All four quantities are powers of two in the synthesizable architecture
(SAR cap groups are binary-ratioed), which is how the explorer encodes
genes; the spec itself stores plain integers.

A copy of `repro.core.acim_spec`: the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class MacroSpec:
    """One synthesizable ACIM macro instance."""

    h: int          # array height (cells per column)
    w: int          # array width (columns == parallel dot products)
    l: int          # local-array size (cells sharing one compute cap)
    b_adc: int      # SAR ADC precision in bits

    def __post_init__(self) -> None:
        if self.h * self.w <= 0:
            raise ValueError(f"bad array dims {self.h}x{self.w}")
        if self.l > self.h:
            raise ValueError(f"L={self.l} > H={self.h}")
        if self.h % self.l != 0:
            raise ValueError(f"L={self.l} must divide H={self.h}")
        if self.n_caps < (1 << self.b_adc):
            raise ValueError(
                f"H/L={self.n_caps} < 2^B_ADC={1 << self.b_adc}: "
                "not enough caps to form the binary CDAC groups")

    @property
    def array_size(self) -> int:
        return self.h * self.w

    @property
    def n_caps(self) -> int:
        """Compute caps per column == accumulation (dot-product) length N."""
        return self.h // self.l

    @property
    def n(self) -> int:
        return self.n_caps

    def sar_groups(self) -> list[int]:
        """CDAC grouping of the N compute caps: 1:1:2:...:2^(B-1), the
        remainder staying as plain compute caps behind the RBL switch
        (opened after redistribution to save conversion energy)."""
        groups = [1] + [1 << i for i in range(self.b_adc)]
        rest = self.n_caps - sum(groups)
        assert rest >= 0
        return groups + ([rest] if rest else [])

    def as_tuple(self) -> tuple[int, int, int, int]:
        return (self.h, self.w, self.l, self.b_adc)

    def name(self) -> str:
        return f"acim_h{self.h}_w{self.w}_l{self.l}_b{self.b_adc}"


def valid_spec(h: int, w: int, l: int, b_adc: int) -> bool:
    try:
        MacroSpec(h, w, l, b_adc)
        return True
    except ValueError:
        return False
