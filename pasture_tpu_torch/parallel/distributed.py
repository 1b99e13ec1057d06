"""Distributed registration: sharded ICP and pose-graph solves.

Port of pasture_tpu/parallel/distributed.py.  Both follow one recipe:
every rank builds the partial normal equations of its shard of the data,
one all-reduce sums the 6x6 (ICP) or (6N)² (pose graph) system over the
mesh's line along ``axis`` (:meth:`~.mesh.Mesh.along`; the work is
sharded over that axis and replicated over the others), and the small
solve runs replicated on every rank — only curvature
and gradient statistics cross between ranks, never points (but for the
partitioned ICP's halo rows).  Every entry point runs inside
:func:`~pasture_tpu_torch._device.fp32_matmul` (no TF32), the port's
counterpart of the reference's highest matmul precision.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .._device import fp32_matmul
from ..buffers.device import PointBatch
from ..layout import attributes as att
from ..registration.icp import (IcpResult, _nearest, _normal_equations,
                                _pose_update)
from ..registration.pose_graph import (PoseGraph, _apply_update, _cg_blocks,
                                       _damped, _dense_step, _pcg_solve,
                                       build_normal_equations)
from ..registration.se3 import transform_points
from . import _comm
from .halo import halo_exchange_local
from .mesh import POINTS_AXIS, Mesh
from .ops import halo_window_fit
from .partition import morton_partition

__all__ = ["distributed_icp", "distributed_icp_partitioned",
           "distributed_pose_graph"]


def _reduced_step(moved, matched, nrm, w, d2, point_to_plane, rot, t,
                  damping, line):
    """This rank's H, b, inlier count and squared error, summed over the
    line in one all-reduce; the replicated solve and pose update."""
    h, b = _normal_equations(moved, matched, nrm, w, point_to_plane)
    sse = torch.sum(torch.where(w > 0, d2, torch.zeros_like(d2)) * w)
    g = _comm.all_reduce(torch.cat([h.reshape(36), b, torch.sum(w)[None],
                                    sse[None]]), "sum", line)
    rot, t = _pose_update(g[:36].reshape(6, 6), g[36:42], rot, t, damping)
    rmse = torch.sqrt(g[43] / torch.clamp_min(g[42], 1.0))
    return rot, t, rmse, g[42]


def distributed_icp(source: torch.Tensor, target: torch.Tensor, mesh: Mesh,
                    source_count: Optional[torch.Tensor] = None,
                    axis: str = POINTS_AXIS,
                    max_correspondence_distance: float = 1.0,
                    iterations: int = 20, damping: float = 1e-6,
                    tile: int = 2048) -> IcpResult:
    """Point-to-point ICP with the source sharded over the mesh.

    ``source`` is this rank's ``(per, 3)`` block of the ``(n·per, 3)``
    source sharded over ``axis`` (``n`` its size); ``source_count`` the
    global count of valid source rows (default all), of which the rank at
    coordinate ``r`` of the axis holds ``clip(count - r·per, 0, per)``;
    ``target`` ``(M, 3)`` is replicated (the map block resident on every
    rank).  Each iteration: this rank's exact nearest neighbours and
    partial H / b, one all-reduce, the replicated 6x6 solve.  Returns the
    replicated :class:`~pasture_tpu_torch.registration.IcpResult`."""
    line = mesh.along(axis)
    per = source.shape[0]
    dtype, dev = source.dtype, source.device
    if source_count is None:
        source_count = per * line.size
    count = torch.as_tensor(source_count, device=dev).to(torch.int64)
    local = torch.clamp(count - line.rank * per, 0, per)
    valid = torch.arange(per, device=dev) < local
    target_valid = torch.ones(target.shape[0], dtype=torch.bool, device=dev)
    max_d2 = max_correspondence_distance ** 2
    rot = torch.eye(3, dtype=dtype, device=dev)
    t = torch.zeros(3, dtype=dtype, device=dev)
    rmse = nin = torch.zeros((), dtype=dtype, device=dev)
    with fp32_matmul():
        for _ in range(iterations):
            moved = transform_points(rot, t, source)
            idx, d2 = _nearest(moved, target, target_valid, tile)
            w = (valid & (d2 < max_d2)).to(dtype)
            rot, t, rmse, nin = _reduced_step(moved, target[idx], None, w,
                                              d2, False, rot, t, damping,
                                              line)
    return IcpResult(rot, t, rmse, nin.to(torch.int32), iterations)


def distributed_icp_partitioned(
        source: PointBatch, target: PointBatch, mesh: Mesh,
        axis: str = POINTS_AXIS, halo: int = 512,
        capacity_factor: float = 2.0,
        max_correspondence_distance: float = 1.0, iterations: int = 20,
        damping: float = 1e-6, tile: int = 2048,
        point_to_plane: bool = False, normals_k: int = 10,
        normals_window: int = 32) -> Tuple[IcpResult, torch.Tensor]:
    """Scan-to-map ICP with both clouds Morton-partitioned over the mesh.

    ``source`` and ``target`` are this rank's shards
    (:func:`~.mesh.shard_batch`).  The target map is partitioned (rank
    ``d`` holds the ``d``-th Morton block, sorted), the scan co-partitioned
    with the map's splitters
    (:class:`~.partition.MortonPartitionSpec`), and each rank matches its
    scan block against its map block plus ``halo`` boundary rows of each
    ring neighbour (:func:`~.halo.halo_exchange_local`); per iteration
    only the 6x6 H / 6-vector b are all-reduced.

    Correctness domain (the reference's): a correspondence is found iff
    the true nearest map point lies in the local block or the halo rows;
    the initial pose error must stay within that margin, as partitioning
    happens once, up front.

    ``point_to_plane``: target normals are fitted per rank on the sorted
    map block padded with ``normals_window`` ring-halo rows (the window fit
    of :func:`~pasture_tpu_torch.algorithms.normals.window_fit`,
    ``normals_k``), and the correspondence halo ships each boundary row's
    home-rank normal with its position.

    The correspondence search and the sums cover each block's valid rows
    only (two counts read on the host once a call, not per iteration):
    the reference's masked padding rows weigh zero.  Returns
    ``(IcpResult, dropped)``, both replicated; ``dropped`` sums the
    overflow of both partitions — callers check it is zero."""
    pos_name = att.POSITION_3D.name

    def pos_only(b: PointBatch) -> PointBatch:
        return PointBatch({pos_name: b.data[pos_name]}, b.count, b.schema,
                          {}, b.policy)

    with fp32_matmul():
        tgt_p, tgt_counts, tgt_drop, spec = morton_partition(
            pos_only(target), mesh, axis, capacity_factor, return_spec=True,
            sort_local=True)
        src_p, src_counts, src_drop = morton_partition(
            pos_only(source), mesh, axis, capacity_factor, spec=spec)
        dropped = tgt_drop.sum() + src_drop.sum()
        line = mesh.along(axis)
        n = line.size
        src, tgt = src_p.data[pos_name], tgt_p.data[pos_name]
        dtype, dev = src.dtype, src.device
        t_cnt = tgt_counts.to(dev)[line.rank]

        if point_to_plane:
            # per-rank target normals: the sorted map block padded with
            # ring-halo rows as the window padding (distributed_normals')
            tgt_normals, _ = halo_window_fit(tgt, t_cnt, n, normals_k,
                                             normals_window, mesh, axis)
            tgt_normals = tgt_normals.to(dtype)
        else:
            tgt_normals = torch.zeros_like(tgt)

        hcols, hcounts = halo_exchange_local(
            {pos_name: tgt, "normal": tgt_normals}, t_cnt, n, halo, mesh,
            axis)
        # the valid rows only: the local block, the left halo's, the
        # right halo's (in the reference's row order, so a tie still goes
        # to the first)
        s_n, t_n, l_n, r_n = (int(v) for v in torch.stack([
            src_counts.to(dev)[line.rank], t_cnt, hcounts[0],
            hcounts[1]]).tolist())
        src = src[:s_n]
        full_t = torch.cat([tgt[:t_n], hcols[pos_name][:l_n],
                            hcols[pos_name][halo:halo + r_n]])
        full_n = torch.cat([tgt_normals[:t_n], hcols["normal"][:l_n],
                            hcols["normal"][halo:halo + r_n]])
        full_valid = torch.ones(full_t.shape[0], dtype=torch.bool,
                                device=dev)
        if not full_t.shape[0]:      # an empty map block: one invalid row
            full_t = full_n = torch.zeros((1, 3), dtype=dtype, device=dev)
            full_valid = torch.zeros(1, dtype=torch.bool, device=dev)
        max_d2 = max_correspondence_distance ** 2
        rot = torch.eye(3, dtype=dtype, device=dev)
        t = torch.zeros(3, dtype=dtype, device=dev)
        rmse = nin = torch.zeros((), dtype=dtype, device=dev)
        for _ in range(iterations):
            moved = transform_points(rot, t, src)
            idx, d2 = _nearest(moved, full_t, full_valid, tile)
            w = (d2 < max_d2).to(dtype)
            rot, t, rmse, nin = _reduced_step(
                moved, full_t[idx], full_n[idx], w, d2, point_to_plane, rot,
                t, damping, line)
    return IcpResult(rot, t, rmse, nin.to(torch.int32), iterations), dropped


def distributed_pose_graph(graph: PoseGraph, mesh: Mesh,
                           axis: str = POINTS_AXIS, iterations: int = 10,
                           damping: float = 1e-6,
                           anchor_weight: float = 1e8,
                           solver: str = "dense", cg_iterations: int = 500,
                           cg_tol: float = 1e-8
                           ) -> Tuple[PoseGraph, torch.Tensor]:
    """Pose-graph Gauss-Newton with the edge set sharded over the mesh.

    ``graph`` is replicated (every rank passes the whole graph); the edges
    are padded with zero-weight self-edges ``(0, 0)`` to a multiple of the
    size of ``axis`` and the ranks at coordinate ``r`` of the axis take
    block ``r``; the sums run over the axis's line.  ``solver="dense"``:
    each rank's partial (6N)² H and b, one all-reduce, a replicated
    Cholesky — to ~2k poses.  ``solver="cg"``: block-sparse PCG; the block diagonal and b
    are all-reduced once a Gauss-Newton step, and each H·x product applies
    this rank's edges and all-reduces one (N, 6) array; the loop keeps the
    reference's relative-residual exit, reading r·z on the host each CG
    iteration as the single-device CG does.

    Returns ``(optimised graph, costs)``, replicated; ``costs[i]`` is the
    squared norm of iteration i's reduced gradient b, as in the
    reference."""
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    line = mesh.along(axis)
    n_size = line.size
    n, e = graph.num_poses, graph.num_edges
    dtype, dev = graph.translations.dtype, graph.translations.device
    weights = (graph.weights if graph.weights is not None
               else torch.ones(e, dtype=dtype, device=dev))
    edges, rel_r, rel_t = (graph.edges, graph.rel_rotations,
                           graph.rel_translations)
    pad = (-e) % n_size
    if pad:
        edges = torch.cat([edges, edges.new_zeros((pad, 2))])
        rel_r = torch.cat([rel_r, torch.eye(3, dtype=dtype, device=dev)
                           .expand(pad, 3, 3)])
        rel_t = torch.cat([rel_t, rel_t.new_zeros((pad, 3))])
        weights = torch.cat([weights, weights.new_zeros(pad)])
    per = (e + pad) // n_size
    lo, hi = line.rank * per, (line.rank + 1) * per
    edges_s, rel_r_s, rel_t_s, w_s = (edges[lo:hi], rel_r[lo:hi],
                                      rel_t[lo:hi], weights[lo:hi])
    step = _xi_dense if solver == "dense" else _xi_cg
    rotations, translations = graph.rotations, graph.translations
    costs = []
    with fp32_matmul():
        for _ in range(iterations):
            xi, cost = step(rotations, translations, edges_s, rel_r_s,
                            rel_t_s, w_s, line, damping, anchor_weight,
                            cg_iterations, cg_tol)
            rotations, translations = _apply_update(rotations, translations,
                                                    xi)
            costs.append(cost)
    costs = torch.stack(costs) if costs else torch.zeros(0, dtype=dtype,
                                                         device=dev)
    return dataclasses.replace(graph, rotations=rotations,
                               translations=translations), costs


def _xi_dense(rotations, translations, edges, rel_r, rel_t, w, line,
              damping, anchor_weight, cg_iterations, cg_tol):
    n6 = 6 * rotations.shape[0]
    h, b = build_normal_equations(rotations, translations, edges, rel_r,
                                  rel_t, w)
    g = _comm.all_reduce(torch.cat([h.reshape(-1), b]), "sum", line)
    b = g[n6 * n6:]
    return _dense_step(g[:n6 * n6].reshape(n6, n6), b, damping,
                       anchor_weight), torch.sum(b * b)


def _xi_cg(rotations, translations, edges, rel_r, rel_t, w, line, damping,
           anchor_weight, cg_iterations, cg_tol):
    n = rotations.shape[0]
    # this rank's edges' share of the block diagonal and b, summed over the
    # line; the off-diagonal blocks stay with their rank
    diag, b, hij = _cg_blocks(rotations, translations, edges, rel_r, rel_t,
                              w)
    g = _comm.all_reduce(torch.cat([diag.reshape(-1), b.reshape(-1)]),
                         "sum", line)
    diag, diag_chol = _damped(g[:36 * n].reshape(n, 6, 6), damping,
                              anchor_weight)
    b = g[36 * n:].reshape(n, 6)
    # the collective of the CG loop: one (N, 6) all-reduce a product
    x = _pcg_solve(diag_chol, hij, hij.mT, edges[:, 0], edges[:, 1], diag,
                   -b, cg_iterations, cg_tol,
                   reduce=lambda y: _comm.all_reduce(y, "sum", line))
    return x, torch.sum(b * b)
