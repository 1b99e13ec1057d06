"""Masked and segmented reductions.

Device-side equivalents of pasture's reduction loops: ``minmax_attribute``
(reference: pasture-algorithms/src/minmax.rs:13-52), ``calculate_bounds``
(bounds.rs:12-100) and the per-voxel centroid reductions
(voxel_grid.rs:168-441).  A batch is padded to capacity and reductions mask
out the invalid tail; segmented ops take a per-point segment id and a
fixed segment count.  As ``jax.ops.segment_*`` does, they drop rows whose
id lies outside ``[0, num_segments)``, give an empty segment the op's
identity, and reduce along axis 0.

NaN semantics match the reference's ``MinMax`` trait (minmax.rs): plain
``<``/``>`` comparisons, so NaNs never win — i.e. NaN-ignoring min/max.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = [
    "masked_min", "masked_max", "masked_minmax", "batch_bounds",
    "segment_sum", "segment_min", "segment_max", "segment_mean",
    "segment_mode",
]


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


# ---- segmented ops -------------------------------------------------------------

def _segment_reduce(x: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, reduce: str, fill) -> torch.Tensor:
    """``(num_segments,) + x.shape[1:]`` of ``fill``, each segment reduced
    with its rows (``"sum"`` adds, ``"amin"`` / ``"amax"`` take the
    extremum); rows with an id outside ``[0, num_segments)`` go to a spare
    segment that is cut off."""
    ids = segment_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                      torch.full_like(ids, num_segments))
    out = torch.full((num_segments + 1,) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    if reduce == "sum":
        out.index_add_(0, ids, x)
    else:
        idx = ids.reshape((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
        out.scatter_reduce_(0, idx, x, reduce, include_self=True)
    return out[:num_segments]


def segment_sum(x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, indices_are_sorted: bool = True
                ) -> torch.Tensor:
    """Per-segment sum in ``x``'s dtype (integer sums wrap).
    ``indices_are_sorted`` is a hint only, as in the reference."""
    return _segment_reduce(x, segment_ids, num_segments, "sum", 0)


def segment_min(x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, indices_are_sorted: bool = True
                ) -> torch.Tensor:
    """Per-segment min; an empty segment is +inf (floats) or the dtype's
    max (integers)."""
    return _segment_reduce(x, segment_ids, num_segments, "amin",
                           _identity(x.dtype, True))


def segment_max(x: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, indices_are_sorted: bool = True
                ) -> torch.Tensor:
    """Per-segment max; an empty segment is -inf (floats) or the dtype's
    min (integers)."""
    return _segment_reduce(x, segment_ids, num_segments, "amax",
                           _identity(x.dtype, False))


def segment_mean(x: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, counts: Optional[torch.Tensor] = None,
                 acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-segment mean, accumulated in ``acc_dtype``; an empty segment is
    0.  ``counts`` (per segment) replaces the count of rows where given."""
    sums = segment_sum(x.to(acc_dtype), segment_ids, num_segments)
    if counts is None:
        counts = segment_sum(torch.ones(x.shape[0], dtype=acc_dtype,
                                        device=x.device),
                             segment_ids, num_segments)
    denom = torch.clamp(counts, min=1).to(acc_dtype)
    while denom.ndim < sums.ndim:
        denom = denom[..., None]
    return sums / denom


def segment_mode(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment most common value ("mode") of an integer column, as
    int32.  Device form of ``centroid_most_common`` (voxel_grid.rs:218-330);
    the reference's HashMap breaks count ties arbitrarily, this picks the
    smallest of the tied values.  An empty segment's mode is int32 max.

    The runs of equal (segment, value) pairs come from one sort; each
    segment keeps its longest run's value.  As in the JAX package, ids at
    or past ``num_segments`` are dropped and negative ids count towards
    segment 0."""
    n = values.shape[0]
    dev = values.device
    v = values.to(torch.int32).to(torch.int64)
    seg = segment_ids.to(torch.int32).to(torch.int64)
    # one sort by (segment, value): the segment in the high word, the value
    # made unsigned in the low one
    order = torch.sort((seg << 32) | (v + (1 << 31))).indices
    seg_s, val_s = seg[order], v[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        first[1:] = (seg_s[1:] != seg_s[:-1]) | (val_s[1:] != val_s[:-1])
    run_id = torch.cumsum(first.to(torch.int64), 0) - 1
    run_len = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, run_id, torch.ones(n, dtype=torch.int64, device=dev))
    # each run's segment and value (every row of a run holds the same)
    run_seg = torch.full((n,), num_segments, dtype=torch.int64, device=dev)
    run_seg.scatter_(0, run_id, seg_s)
    run_val = torch.zeros(n, dtype=torch.int32, device=dev)
    run_val.scatter_(0, run_id, val_s.to(torch.int32))
    ok = (run_len > 0) & (run_seg < num_segments)
    run_seg_c = torch.clamp(run_seg, 0, num_segments - 1)
    best_len = segment_max(torch.where(ok, run_len, -1), run_seg_c,
                           num_segments)
    is_best = ok & (run_len == best_len[run_seg_c])
    big = torch.iinfo(torch.int32).max
    return segment_min(torch.where(is_best, run_val, big), run_seg_c,
                       num_segments)
