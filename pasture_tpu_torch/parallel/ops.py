"""Sharded map-style ops over the mesh.

Port of pasture_tpu/parallel/ops.py.  Each rank computes on its own shard
and the ranks meet in collectives of statistics only, on the line of the
mesh along the op's ``axis`` (:meth:`~.mesh.Mesh.along`): the result is
sharded over that axis and replicated over the others.

* ``sharded_bounds`` — masked min / max per rank, one all-reduce;
* ``sharded_voxel_downsample`` — a per-rank voxelize against the global
  grid origin (the ranks' ``min``), so a rank's shard takes the tiled and
  quantized fast paths (``tile_sort`` + ``fused_sorted_voxel_reduce``);
* ``sharded_voxel_downsample_merged`` — the same ``with_aux``, every
  rank's stage-1 batch and merge statistics all-gathered at their
  capacity rows, and on every rank the exact two-stage merge
  (:func:`~pasture_tpu_torch.ops.merge_voxel_batches`): the result is
  replicated and equals the one-shot single-device voxelization for the
  mean / max policies, and for mode too with ``mode_runs=True``;
* ``distributed_normals`` — Morton partition, then each rank's sorted
  block padded with its ring neighbours' boundary rows, fitted by the
  window kernel (K6).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..buffers.device import PointBatch
from ..layout import attributes as att
from ..ops.reductions import batch_bounds
from ..ops.voxel import voxel_downsample
from . import _comm
from .halo import halo_exchange_local
from .mesh import POINTS_AXIS, Mesh
from .partition import morton_partition
from .spans import span

__all__ = ["sharded_bounds", "sharded_voxel_downsample",
           "sharded_voxel_downsample_merged", "distributed_normals",
           "halo_window_fit"]


def _global_bounds(pos: torch.Tensor, mask: torch.Tensor, mesh: Mesh):
    lmin, lmax = batch_bounds(pos, mask)
    g = _comm.all_reduce(torch.cat([lmin, -lmax]), "min", mesh)
    return g[:3], -g[3:]


def sharded_bounds(batch: PointBatch, mesh: Mesh, axis: str = POINTS_AXIS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global AABB ``(min, max)`` of a batch sharded over ``axis``, the
    same on every rank: each rank's masked min / max, then one all-reduce
    over the axis."""
    return _global_bounds(batch.data[att.POSITION_3D.name],
                          batch.valid_mask(), mesh.along(axis))


def _local_count(batch: PointBatch, per_shard_counts, line: Mesh):
    if per_shard_counts is None:
        return torch.clamp(batch.count, 0, batch.capacity)
    return torch.as_tensor(per_shard_counts).to(batch.device)[line.rank]


def sharded_voxel_downsample(batch: PointBatch, mesh: Mesh, leaf_size,
                             axis: str = POINTS_AXIS,
                             semantics: str = "floor",
                             per_shard_counts: Optional[torch.Tensor] = None,
                             with_aux: bool = False, **voxel_kwargs):
    """Two-stage distributed voxel downsample, stage 1.

    Every rank voxelizes its shard against the global grid origin (the
    ``min`` of the bounds of the ranks on its ``axis`` line), with no
    other communication; a voxel whose points straddle shards appears once
    per shard.  ``per_shard_counts`` (the axis's length, after
    :func:`~.partition.morton_partition`) gives each shard's valid prefix;
    without it the batch's own count does (a :func:`~.mesh.shard_batch`
    shard).

    Returns ``(batch, per_shard_counts)`` — or ``(batch, per_shard_counts,
    aux)`` with ``with_aux`` — where the batch is this rank's voxels (its
    prefix of ``per_shard_counts[r]`` rows, ``r`` its coordinate on
    ``axis``) with ``count`` the global total, ``per_shard_counts`` the
    voxel counts of the axis's shards, and ``aux`` this rank's merge
    statistics of :func:`~pasture_tpu_torch.ops.voxel_downsample`.  Extra
    ``voxel_kwargs`` (``grid_bits``, ``position_quantization_bits``,
    ``sort_tiles``, ``mode_runs`` ...) go to the per-rank call."""
    line = mesh.along(axis)
    pos = batch.data[att.POSITION_3D.name]
    count = _local_count(batch, per_shard_counts, line)
    local = PointBatch(dict(batch.data), count.to(torch.int32),
                       batch.schema, dict(batch.meta), batch.policy)
    gmin, _ = _global_bounds(pos, local.valid_mask(), line)
    with span("voxelize", batch.device):
        out = voxel_downsample(local, leaf_size, bounds=(gmin, None),
                               semantics=semantics, with_aux=with_aux,
                               **voxel_kwargs)
    aux = None
    if with_aux:
        out, aux = out
    counts = _comm.all_gather(out.count.to(torch.int64), line)
    result = PointBatch(out.data, counts.sum().to(torch.int32), batch.schema,
                        batch.meta, batch.policy)
    if with_aux:
        return result, counts, aux
    return result, counts


def sharded_voxel_downsample_merged(batch: PointBatch, mesh: Mesh,
                                    leaf_size, axis: str = POINTS_AXIS,
                                    semantics: str = "floor",
                                    per_shard_counts: Optional[torch.Tensor]
                                    = None, **voxel_kwargs):
    """Distributed voxelize and exact global merge in one call.

    :func:`sharded_voxel_downsample` ``with_aux``, then every rank gathers
    the stage-1 batches and merge statistics of its ``axis`` line (one
    all-gather of their packed bytes) and merges them in shard order with
    :func:`~pasture_tpu_torch.ops.merge_voxel_batches`.  What is gathered
    is each rank's whole stage-1 batch and aux at its capacity rows (the
    shard's point capacity, ``voxel_downsample`` keeping it), not trimmed
    to the voxel count: with ``mode_runs`` on a 15 000 064-row shard of
    POSITION_3D, INTENSITY and CLASSIFICATION that is 77 bytes a capacity
    row, 1 155 004 928 bytes a rank, where the shard holds ~5.6 M voxels
    (``collective_counts()["all_gather"]`` read 1 155 004 944 bytes a fold
    on each of four H100s, the 16 more being the voxel counts' gather and
    the run table's ``num_runs``, each padded to 8).  Returns ``(batch, aux)``,
    replicated: the centroid values equal the one-shot single-device
    voxelization for mean / max (mode: exact with ``mode_runs=True`` in
    ``voxel_kwargs``, the weighted-vote envelope otherwise)."""
    from ..ops.voxel_merge import merge_voxel_batches

    vox, counts, aux = sharded_voxel_downsample(
        batch, mesh, leaf_size, axis=axis, semantics=semantics,
        per_shard_counts=per_shard_counts, with_aux=True, **voxel_kwargs)
    with span("gather", batch.device):
        parts = _comm.all_gather_tree((vox.data, aux), mesh.along(axis))
    with span("merge", batch.device):
        return merge_voxel_batches(
            [(PointBatch(data, counts[r].to(torch.int32), vox.schema,
                         vox.meta, vox.policy), a)
             for r, (data, a) in enumerate(parts)],
            policies=voxel_kwargs.get("policies"))


def distributed_normals(batch: PointBatch, mesh: Mesh, k: int,
                        window: int = 64, axis: str = POINTS_AXIS,
                        capacity_factor: float = 2.0):
    """Normals and curvature of a sharded cloud, halo-windowed.

    Morton-partitions the positions with each rank's block sorted
    (``sort_local``), then fits each rank's points against its sorted block
    padded with the ring neighbours' ``window`` boundary rows
    (:func:`~.halo.halo_exchange_local`) by the window fit (K6 on the
    card): the per-rank form of ``compute_normals(method="morton")`` on one
    curve, the halo standing in for the curve's continuation across ranks.

    Returns ``(part, normals, curvature, counts, dropped)``: ``part`` is
    this rank's block of the partitioned positions, which the results align
    with row for row (rows past ``counts[r]`` are not points, ``r`` this
    rank's coordinate on ``axis``), ``counts`` / ``dropped`` the
    partition's counts, of the axis's length."""
    pos_name = att.POSITION_3D.name
    pos_only = PointBatch({pos_name: batch.data[pos_name]}, batch.count,
                          batch.schema, {}, batch.policy)
    part, counts, dropped = morton_partition(
        pos_only, mesh, axis, capacity_factor, sort_local=True)
    line = mesh.along(axis)
    pos_s = part.data[pos_name]
    cnt = counts.to(pos_s.device)[line.rank]
    normal, curvature = halo_window_fit(pos_s, cnt, line.size, k, window,
                                        mesh, axis)
    return part, normal, curvature, counts, dropped


def halo_window_fit(pos_s: torch.Tensor, cnt: torch.Tensor, n: int, k: int,
                    w: int, mesh: Mesh, axis: str = POINTS_AXIS):
    """Window-fit normals of a rank's sorted block ``pos_s`` (valid prefix
    ``cnt``) padded with ``w`` halo rows of each ring neighbour, the
    reference's layout (the ring of the mesh's ``axis`` line): the block's
    ``cap`` rows between the halos, rows past the count ``inf``.  Only the
    valid rows are fitted (their windows, ``[i, i + 2w]`` of the padded
    array, hold the same candidates as in the reference; the count is read
    on the host once); rows past the count come back zero.  Returns ``(normal (cap, 3), curvature
    (cap,))``."""
    from ..algorithms.normals import window_fit

    halo_cols, halo_counts = halo_exchange_local({"pos": pos_s}, cnt, n, w,
                                                 mesh, axis)
    hpos = halo_cols["pos"]
    hidx = torch.arange(w, device=pos_s.device)
    inf = torch.full_like(hpos[:w], float("inf"))
    left = torch.where((hidx < halo_counts[0])[:, None], hpos[:w], inf)
    right = torch.where((hidx < halo_counts[1])[:, None], hpos[w:], inf)
    c = int(cnt)
    sp = torch.cat([pos_s[:c], torch.full_like(pos_s[c:], float("inf"))])
    pp = torch.cat([left, sp, right])
    normal = torch.zeros_like(pos_s)
    curvature = pos_s.new_zeros(pos_s.shape[0])
    if c:
        nrm, curv, _ = window_fit(sp[:c], pp[:c + 2 * w], k, w)
        normal[:c] = nrm.to(pos_s.dtype)
        curvature[:c] = curv.to(pos_s.dtype)
    return normal, curvature
