"""Min/max semantics (reference: pasture-core/src/math/minmax.rs:7-80).

The reference's ``MinMax`` trait computes infimum/supremum with plain ``<`` /
``>`` comparisons, which *ignores NaNs* for floats (a NaN never wins a
comparison).  These helpers reproduce that for whole columns, componentwise
for vector attributes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["infimum", "supremum", "minmax_column"]


def infimum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Componentwise min, NaN-ignoring for floats (fmin semantics)."""
    if np.issubdtype(np.asarray(a).dtype, np.floating):
        return np.fmin(a, b)
    return np.minimum(a, b)


def supremum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Componentwise maximum (the reference's ``Supremum`` trait for
    position vectors, math/minmax.rs)."""
    if np.issubdtype(np.asarray(a).dtype, np.floating):
        return np.fmax(a, b)
    return np.maximum(a, b)


def minmax_column(col: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(min, max) over axis 0, NaN-ignoring; None for empty input.

    Matches pasture-algorithms ``minmax_attribute`` (minmax.rs:13-52)."""
    col = np.asarray(col)
    if col.shape[0] == 0:
        return None
    if np.issubdtype(col.dtype, np.floating):
        with np.errstate(invalid="ignore"):
            mn = np.nanmin(col, axis=0)
            mx = np.nanmax(col, axis=0)
        return mn, mx
    return col.min(axis=0), col.max(axis=0)
