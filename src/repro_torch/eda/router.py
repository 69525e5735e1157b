"""Grid-router helpers shared by the batched flow (paper Sec. 2.3 / 3.3).

Counterpart of the parts of `repro.eda.router` the batched flow uses:
the coarse routing-grid extent of a macro and the backtrace preference
order.  The backtrace tie-break — at distance d step to the first
neighbour at d-1 in `NEIGHBORS` order — is what makes the batched
router's paths identical to the reference's.
"""
from __future__ import annotations

# Backtrace preference order (down, up, right, left).
NEIGHBORS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def grid_shape(width: int, height: int, coarse: int) -> tuple[int, int]:
    """Coarse routing-grid extent (rows, columns) for a macro bounding box."""
    return (max(2, height // coarse + 3), max(2, width // coarse + 2))
