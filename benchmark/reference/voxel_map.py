"""Plain PyTorch references of the two voxel maps the benchmark checks.

Each works the map out again from the benchmark's own inputs (the integer
LAS coordinates, intensities and classes the scene generator made), never
from anything the program derived.  Both follow the semantics the
configuration states: a point falls in ``floor((p - anchor) / leaf)``
computed on its float32 map position, a voxel's centroid is the mean of
its points (worked out here in float64; the program's float32 result may
differ from it by its own rounding), its intensity the mean truncated to
an integer and its classification the most common class, ties to the
smallest.

``precision`` names the float type of the positions and of every mean:
``"float32"`` for the stated semantics, ``"bfloat16"`` for the control,
the nearest precision below it, which a correct comparison has to
reject.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _spread10(v: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of ``v`` spread three apart (the Morton interleave)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _gather10(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_spread10`."""
    v = v & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x3FF
    return v


def morton10(cell: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code of (n, 3) cells of 10 bits, x in the lowest bit."""
    c = cell.to(torch.int64)
    return _spread10(c[:, 0]) | (_spread10(c[:, 1]) << 1) \
        | (_spread10(c[:, 2]) << 2)


def cells_of_morton60(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(n, 3) cells of a 60-bit Morton code given as its high and low 30
    bits (each a 10-bit-a-axis interleave, x lowest)."""
    hi = hi.to(torch.int64) & 0xFFFFFFFF
    lo = lo.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([_gather10(lo >> a) | (_gather10(hi >> a) << 10)
                        for a in range(3)], dim=1)


def linear_code(cell: torch.Tensor) -> torch.Tensor:
    """One int64 per (n, 3) cell of at most 21 bits an axis."""
    c = cell.to(torch.int64)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def _mode(group: torch.Tensor, values: torch.Tensor, groups: int
          ) -> torch.Tensor:
    """The most common value of each group, ties to the smallest value."""
    pair = group * 65536 + values.to(torch.int64)
    u, c = torch.unique(pair, return_counts=True)
    g, v = u // 65536, u % 65536
    # order by (group, count descending, value ascending): first of a group
    inner = torch.sort((c.max() + 1 - c) * 65536 + v, stable=True).indices
    outer = torch.sort(g[inner], stable=True).indices
    order = inner[outer]
    g, v = g[order], v[order]
    first = torch.ones_like(g, dtype=torch.bool)
    first[1:] = g[1:] != g[:-1]
    out = torch.zeros(groups, dtype=torch.int64, device=g.device)
    out[g[first]] = v[first]
    return out


def _reduce(key: torch.Tensor, exact: torch.Tensor, low: torch.Tensor,
            intensity: torch.Tensor, classification: torch.Tensor,
            precision: str) -> Dict[str, torch.Tensor]:
    """Group rows by ``key`` (ascending): point counts, centroids (the
    float64 mean of ``exact``, or for the control the ``low``-precision
    mean of ``low``), truncated mean intensity and mode class."""
    uniq, inv, counts = torch.unique(key, return_inverse=True,
                                     return_counts=True)
    m = uniq.shape[0]
    if precision == "float32":
        sums = torch.zeros((m, 3), dtype=torch.float64, device=key.device)
        sums.index_add_(0, inv, exact.to(torch.float64))
        centroid = sums / counts[:, None].to(torch.float64)
        isum = torch.zeros(m, dtype=torch.int64, device=key.device)
        isum.index_add_(0, inv, intensity.to(torch.int64))
        inten = isum // counts
    else:
        dt = _DTYPES[precision]
        sums = torch.zeros((m, 3), dtype=dt, device=key.device)
        sums.index_add_(0, inv, low.to(dt))
        centroid = (sums / counts[:, None].to(dt)).to(torch.float64)
        isum = torch.zeros(m, dtype=dt, device=key.device)
        isum.index_add_(0, inv, intensity.to(dt))
        inten = torch.trunc(isum / counts.to(dt)).to(torch.int64)
    return {"key": uniq, "counts": counts, "centroid": centroid,
            "intensity": inten,
            "classification": _mode(inv, classification, m)}


def fold_map(local: torch.Tensor, intensity: torch.Tensor,
             classification: torch.Tensor, scale, offset, leaf: float,
             grid_bits: int, precision: str = "float32"
             ) -> Dict[str, torch.Tensor]:
    """The map of a whole file: every point's map position ``local *
    scale + offset`` in float64, narrowed to ``precision`` (as the file is
    read), binned on a grid anchored at the minimum (the header's bounds),
    cells clamped to ``grid_bits`` bits an axis; a centroid is the mean of
    the narrowed positions.  Rows are keyed by :func:`linear_code`."""
    dev = local.device
    scale = torch.as_tensor(scale, dtype=torch.float64, device=dev)
    offset = torch.as_tensor(offset, dtype=torch.float64, device=dev)
    pos = local.to(torch.float64) * scale + offset
    dt = _DTYPES[precision]
    p = pos.to(dt)
    anchor = pos.min(dim=0).values.to(dt)
    cell = torch.clamp(torch.floor((p - anchor) / leaf), 0,
                       (1 << grid_bits) - 1).to(torch.int64)
    return _reduce(linear_code(cell), p, p, intensity, classification,
                   precision)


def tiled_step_map(local: torch.Tensor, intensity: torch.Tensor,
                   classification: torch.Tensor, scale, offset, leaf: float,
                   tile_rows: int, precision: str = "float32"
                   ) -> Dict[str, torch.Tensor]:
    """The map of one tiled step: the batch's rows cut into tiles of
    ``tile_rows``, each voxelized on its own (one row per (tile, voxel)), on
    a 10-bit grid anchored at the batch's float32 map minimum floored to a
    whole leaf.  Map positions are ``local * scale + offset`` in float32,
    one rounded operation after the other, scale and offset rounded to
    float32 (no rotation); a centroid is the exact mean of ``local * scale
    + offset``.  Rows come in (tile, Morton code) order."""
    dev = local.device
    dt = _DTYPES[precision]
    s32 = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    o32 = torch.as_tensor(offset, dtype=torch.float32, device=dev)
    world = local.to(torch.float32) * s32 + o32
    wmin = world.min(dim=0).values
    anchor = torch.floor(wmin / leaf) * leaf
    w = world.to(dt)
    cell = torch.clamp(torch.floor((w - anchor.to(dt)) * (1.0 / leaf)), 0,
                       1023).to(torch.int64)
    tile = torch.arange(local.shape[0], device=dev) // tile_rows
    key = (tile << 30) | morton10(cell)
    exact = local.to(torch.float64) * torch.as_tensor(
        scale, dtype=torch.float64, device=dev) + torch.as_tensor(
        offset, dtype=torch.float64, device=dev)
    return _reduce(key, exact, w, intensity, classification, precision)
