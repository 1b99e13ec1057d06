"""Masked reductions.

Device-side equivalents of pasture's reduction loops: ``minmax_attribute``
(reference: pasture-algorithms/src/minmax.rs:13-52) and ``calculate_bounds``
(bounds.rs:12-100).  A batch is padded to capacity and reductions mask out
the invalid tail.  Segment totals are not a module here: they are
``index_add_`` / ``scatter_reduce_`` on segment ids where they are needed
(ops/voxel.py).

NaN semantics match the reference's ``MinMax`` trait (minmax.rs): plain
``<``/``>`` comparisons, so NaNs never win — i.e. NaN-ignoring min/max.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["masked_min", "masked_max", "masked_minmax", "batch_bounds"]


def _identity(dtype: torch.dtype, for_min: bool):
    """Neutral element so padded rows never win a min/max."""
    if dtype.is_floating_point:
        return float("inf") if for_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if for_min else info.min


def _masked_fill(x: torch.Tensor, mask: torch.Tensor, for_min: bool
                 ) -> torch.Tensor:
    m = mask
    while m.ndim < x.ndim:
        m = m[..., None]
    fill = _identity(x.dtype, for_min)
    filled = torch.where(m, x, torch.full_like(x, fill))
    if x.dtype.is_floating_point:
        filled = torch.where(torch.isnan(filled),
                             torch.full_like(x, fill), filled)
    return filled


def masked_min(x: torch.Tensor, mask: torch.Tensor, axis: int = 0
               ) -> torch.Tensor:
    """Min over valid rows; NaN-ignoring for floats (minmax.rs semantics)."""
    return torch.amin(_masked_fill(x, mask, True), dim=axis)


def masked_max(x: torch.Tensor, mask: torch.Tensor, axis: int = 0
               ) -> torch.Tensor:
    """Max over ``axis`` ignoring masked-out rows and NaNs."""
    return torch.amax(_masked_fill(x, mask, False), dim=axis)


def masked_minmax(x: torch.Tensor, mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) per component over valid rows — device analog of
    ``minmax_attribute`` (minmax.rs:13-52)."""
    return masked_min(x, mask), masked_max(x, mask)


def batch_bounds(positions: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABB (min, max) of POSITION_3D — device ``calculate_bounds``
    (bounds.rs:12-100)."""
    return masked_minmax(positions, mask)
