"""Spatial sorting of point batches.

Replaces pasture's sorted-``Vec`` voxel insertion (reference:
pasture-algorithms/src/voxel_grid.rs:130-153, an O(n·v) linear scan + binary
search insert) with one stable sort over Morton keys — the canonical
sort-based regrouping on accelerators.  Keys are dual-u32 Morton codes
(pasture_tpu_torch/math/morton.py), each in its int64 carrier.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..buffers.device import PointBatch
from ..math.morton import morton_encode_dual32
from .kernels.tile_sort_kernel import lex_order

__all__ = ["sort_by_keys", "morton_sort"]


def sort_by_keys(batch: PointBatch, *keys: torch.Tensor
                 ) -> Tuple[PointBatch, Tuple[torch.Tensor, ...],
                            torch.Tensor]:
    """Sort a batch by one or more key columns (lexicographic, stable).
    Each key compares as the integers its tensor holds: a u32 key in its
    int64 carrier compares unsigned, an int32 tensor signed.

    Invalid (padded) rows must already carry a key that sorts last.  Returns
    ``(sorted_batch, sorted_keys, permutation)``, the permutation as int64
    row indices."""
    if not keys:
        raise ValueError("sort_by_keys needs at least one key column")
    n = batch.capacity
    perm = lex_order(list(keys), n) if n else torch.zeros(
        0, dtype=torch.int64, device=batch.device)
    sorted_keys = tuple(k.index_select(0, perm) for k in keys)
    return batch.gather(perm), sorted_keys, perm


def morton_sort(batch: PointBatch, cell_indices: torch.Tensor
                ) -> Tuple[PointBatch, Tuple[torch.Tensor, torch.Tensor],
                           torch.Tensor]:
    """Sort by the Morton code of integer cell indices ``(N, 3)``.

    Invalid rows should carry the maximal cell index so they sort last."""
    hi, lo = morton_encode_dual32(cell_indices[:, 0], cell_indices[:, 1],
                                  cell_indices[:, 2])
    return sort_by_keys(batch, hi, lo)
