"""Halo exchange: ring-style neighbour block exchange over the mesh.

Port of pasture_tpu/parallel/halo.py.  After
:func:`~.partition.morton_partition` each rank owns a contiguous Morton
range, and spatially adjacent ranges live on neighbouring ranks;
neighbourhood ops near a block boundary need the neighbours' boundary rows.
``halo_exchange`` ships each rank's first and last ``halo`` valid rows to
its ring neighbours on the mesh's line along ``axis`` — the reference's
``ppermute`` pair, here one ``batch_isend_irecv`` of all columns and the
counts packed together.

* :func:`halo_exchange_local` — the per-rank body, for callers that hold a
  rank's columns (``distributed_normals``, the partitioned ICP);
* :func:`halo_exchange` — on a partitioned batch and its counts.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..buffers.device import PointBatch
from . import _comm
from .mesh import POINTS_AXIS, Mesh

__all__ = ["halo_exchange", "halo_exchange_local"]


def halo_exchange_local(data: Dict[str, torch.Tensor], count: torch.Tensor,
                        n_shards: int, halo: int, mesh: Mesh,
                        axis: str = POINTS_AXIS
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Per-rank halo exchange over the ring of the mesh's line along
    ``axis`` (``n_shards`` its size).

    ``data``: this rank's columns (valid prefix of ``count`` rows, at least
    ``halo`` rows each).  Returns ``(halo_cols, halo_counts)``: ``2·halo``
    rows per column — the last ``halo`` valid rows of the left ring
    neighbour, then the first ``halo`` rows of the right; past a block's
    count its rows are the neighbour's rows there (zeros in a partitioned
    batch) — and ``halo_counts = (left_n, right_n)`` (int64)."""
    line = mesh.along(axis)
    if n_shards != line.size:
        raise ValueError(f"n_shards={n_shards} on an axis of {line.size}")
    names = list(data)
    per = data[names[0]].shape[0]
    if per < halo:
        raise ValueError(f"halo {halo} exceeds the {per} rows of a shard")
    count = torch.as_tensor(count, device=data[names[0]].device).to(
        torch.int64)
    n_edge = torch.clamp(count, max=halo).reshape(1)
    # the tail block: rows [count - halo, count) clamped into the shard
    # (the reference's static-size dynamic slice; masked by n_edge)
    start = torch.clamp(count - halo, 0, per - halo)
    tail_rows = start + torch.arange(halo, device=count.device)
    heads = [data[k][:halo][None] for k in names]
    tails = [data[k][tail_rows][None] for k in names]
    head_buf, layout = _comm.pack(heads + [n_edge[None]], 1)
    tail_buf, _ = _comm.pack(tails + [n_edge[None]], 1)
    # my tail -> right neighbour's LEFT halo; my head -> left's RIGHT halo
    from_left, from_right = _comm.ring_exchange(tail_buf, head_buf, line)
    left, right = (_comm.unpack(b, layout) for b in (from_left, from_right))
    halo_cols = {k: torch.cat([left[i][0], right[i][0]])
                 for i, k in enumerate(names)}
    return halo_cols, torch.cat([left[-1][0], right[-1][0]])


def halo_exchange(batch: PointBatch, per_shard_counts: torch.Tensor,
                  mesh: Mesh, halo: int, axis: str = POINTS_AXIS
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Exchange boundary rows with the ring neighbours.

    ``batch`` is this rank's block of a batch partitioned over ``axis``
    with ``per_shard_counts`` (the axis's length, as :func:`~.partition
    .morton_partition` returns them).  Returns this rank's ``(halo_columns,
    halo_counts)``: ``2·halo`` rows per column (left halo then right halo)
    and its ``(2,)`` counts — this rank's row of the
    reference's ``(n_shards, 2)`` array."""
    line = mesh.along(axis)
    count = per_shard_counts.to(batch.device)[line.rank]
    return halo_exchange_local(batch.data, count, line.size, halo, mesh,
                               axis)
