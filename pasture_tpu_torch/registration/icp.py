"""ICP scan-to-map registration on device.

Port of pasture_tpu/registration/icp.py.  Correspondences come either from
brute-force nearest neighbours (tiled true-fp32 distance matmuls plus
``argmin``) or from a Morton-window match (both clouds co-sorted on one
Morton curve, the best target among each source row's ±``window`` rank
neighbours).  The 6x6 Gauss-Newton normal equations are built with masked
einsums and solved by Cholesky.  The fixed number of iterations is a
Python loop in which nothing is read back to the host.

Point-to-point and point-to-plane objectives; point-to-plane takes target
normals from :mod:`pasture_tpu_torch.algorithms.normals` when none are
given (on the Morton path the K6 window fit).  Correspondences beyond
``max_correspondence_distance`` get weight zero.

On float32 tensors the exact path runs each iteration as K8
(:mod:`pasture_tpu_torch.ops.kernels.icp_step_kernel`): the nearest
neighbours by direct float32 differences and the normal equations in one
step, the float64 solve and pose update in the other, the pose in one
buffer between them; on CUDA these are the two kernels' launches, on the
CPU their plain version.  float64 and the Morton path run the loop below.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .._device import fp32_matmul
from ..algorithms.normals import (_morton_window_normals, _normals_device,
                                  _valid_extent, morton_order)
from ..ops.kernels.icp_step_kernel import icp_iterate
from .se3 import se3_exp, skew, transform_points

__all__ = ["icp", "IcpResult", "nearest_neighbors", "morton_nearest_target"]


@dataclasses.dataclass
class IcpResult:
    """Final alignment: ``rotation @ p + translation`` maps source into the
    target frame.  Tensors on the inputs' device."""

    rotation: torch.Tensor      # (3, 3)
    translation: torch.Tensor   # (3,)
    rmse: torch.Tensor          # 0-d: inlier RMSE at the last iteration
    num_inliers: torch.Tensor   # 0-d int32
    iterations: int


def nearest_neighbors(query: torch.Tensor, points: torch.Tensor,
                      points_valid: torch.Tensor, tile: int = 2048
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices int64, squared distances) of the nearest valid target point
    for each query row; the first index wins a tie.  Tiled so the distance
    matrix never exceeds ``tile x N``; the distance products run in true
    fp32."""
    with fp32_matmul():
        return _nearest(query, points, points_valid, tile)


def _nearest(query, points, points_valid, tile):
    p2 = torch.sum(points * points, dim=1)[None, :]
    idx, d2 = [], []
    for i in range(0, query.shape[0], tile):
        qt = query[i:i + tile]
        q2 = torch.sum(qt * qt, dim=1, keepdim=True)
        d = q2 + p2 - 2.0 * (qt @ points.T)
        d = torch.where(points_valid[None, :], d,
                        torch.full_like(d, float("inf")))
        best = torch.argmin(d, dim=1)
        idx.append(best)
        d2.append(torch.gather(d, 1, best[:, None])[:, 0])
    return torch.cat(idx), torch.cat(d2)


def morton_nearest_target(moved: torch.Tensor, source_valid: torch.Tensor,
                          target: torch.Tensor, target_valid: torch.Tensor,
                          bounds_min: torch.Tensor, extent: torch.Tensor,
                          window: int,
                          target_normals: Optional[torch.Tensor] = None):
    """Approximate nearest target of each source row in O((N+M)·window).

    Both clouds are co-sorted on one Morton curve (isotropic 20-bit grid
    anchored at ``bounds_min`` with the largest ``extent``); each source row
    takes the nearest valid target row within ±``window`` ranks — a running
    minimum over the shifts -w..w with a strict ``<``, so the first best in
    shift order wins.  Results go back to source order by a scatter.

    Returns ``(matched_positions (N, 3), sq_distances (N,))``, and with
    ``target_normals`` a third element, the matched target's normal (N, 3).
    A source row whose nearest target lies outside the window gets a
    farther match; one with no valid target in its window gets ``inf``
    and zeros."""
    n, m = moved.shape[0], target.shape[0]
    dtype, dev = moved.dtype, moved.device
    with_normals = target_normals is not None

    pos = torch.cat([moved, target])
    valid = torch.cat([source_valid, target_valid])
    is_target = torch.cat([torch.zeros(n, dtype=torch.bool, device=dev),
                           torch.ones(m, dtype=torch.bool, device=dev)])
    iso = torch.clamp_min(torch.max(extent), 1e-9)
    perm = morton_order(pos, valid, bounds_min, iso)
    sp = pos[perm]
    cand_ok = (valid & is_target)[perm]           # valid TARGET rows only
    inf = float("inf")
    cp = torch.where(cand_ok[:, None], sp, torch.full_like(sp, inf))

    w = window
    rows = n + m
    cpp = torch.cat([torch.full((w, 3), inf, dtype=dtype, device=dev), cp,
                     torch.full((w, 3), inf, dtype=dtype, device=dev)])
    if with_normals:
        nrm = torch.cat([torch.zeros((n, 3), dtype=dtype, device=dev),
                         target_normals.to(dtype)])[perm]
        zeros = torch.zeros((w, 3), dtype=dtype, device=dev)
        cnn = torch.cat([zeros, torch.where(cand_ok[:, None], nrm,
                                            torch.zeros_like(nrm)), zeros])

    bestd2 = torch.full((rows,), inf, dtype=dtype, device=dev)
    bpos = torch.zeros((rows, 3), dtype=dtype, device=dev)
    bnrm = torch.zeros((rows, 3), dtype=dtype, device=dev)
    for j in range(2 * w + 1):
        q = cpp[j:j + rows]
        d = sp - q
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        better = d2 < bestd2              # inf and NaN are never better
        bestd2 = torch.where(better, d2, bestd2)
        bpos = torch.where(better[:, None], q, bpos)
        if with_normals:
            bnrm = torch.where(better[:, None], cnn[j:j + rows], bnrm)

    # back to input order; the source rows are the first n
    out_d2 = torch.empty_like(bestd2)
    out_d2[perm] = bestd2
    out_pos = torch.empty_like(bpos)
    out_pos[perm] = bpos
    if with_normals:
        out_nrm = torch.empty_like(bnrm)
        out_nrm[perm] = bnrm
        return out_pos[:n], out_d2[:n], out_nrm[:n]
    return out_pos[:n], out_d2[:n]


def _solve_gn(h: torch.Tensor, b: torch.Tensor, damping: float
              ) -> torch.Tensor:
    """(H + damping I)^-1 b by Cholesky, without a host sync."""
    h = h + damping * torch.eye(6, dtype=h.dtype, device=h.device)
    chol = torch.linalg.cholesky_ex(h).L
    y = torch.linalg.solve_triangular(chol, b[:, None], upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)[:, 0]


def _normal_equations(moved, matched, nrm, w, point_to_plane):
    """The 6x6 H and 6-vector b of one Gauss-Newton step from the moved
    source rows, their matches (and the matches' normals) and weights."""
    if point_to_plane:
        r = torch.sum((moved - matched) * nrm, dim=1)           # (N,)
        # J_i = [n_i^T, (p_i x n_i)^T] for twist [rho, phi]
        j = torch.cat([nrm, torch.linalg.cross(moved, nrm)], dim=1)
        jw = j * w[:, None]
        return jw.T @ j, jw.T @ r
    r = moved - matched                                          # (N, 3)
    # J_i = [I, -[p]_x] per residual row
    eye = torch.eye(3, dtype=moved.dtype,
                    device=moved.device).expand(moved.shape[0], 3, 3)
    j = torch.cat([eye, -skew(moved)], dim=2)                    # (N, 3, 6)
    jw = j * w[:, None, None]
    return (torch.einsum("nai,naj->ij", jw, j),
            torch.einsum("nai,na->i", jw, r))


def _pose_update(h, b, rot, t, damping):
    """The pose after the damped Gauss-Newton step of ``(h, b)``."""
    xi = -_solve_gn(h, b, damping)
    d_rot, d_t = se3_exp(xi)
    return d_rot @ rot, d_rot @ t + d_t


def _icp_step(source, source_valid, corr_fn, rot, t, max_dist_sq,
              point_to_plane, damping):
    moved = transform_points(rot, t, source)
    matched, d2, nrm = corr_fn(moved)
    w = (source_valid & (d2 < max_dist_sq)).to(source.dtype)
    h, b = _normal_equations(moved, matched, nrm, w, point_to_plane)
    new_rot, new_t = _pose_update(h, b, rot, t, damping)
    nin = torch.sum(w)
    rmse = torch.sqrt(torch.sum(torch.where(w > 0, d2, torch.zeros_like(d2))
                                * w) / torch.clamp_min(nin, 1.0))
    return new_rot, new_t, rmse, nin


def icp(source: torch.Tensor, target: torch.Tensor,
        source_valid: Optional[torch.Tensor] = None,
        target_valid: Optional[torch.Tensor] = None,
        init_rotation: Optional[torch.Tensor] = None,
        init_translation: Optional[torch.Tensor] = None,
        max_correspondence_distance: float = 1.0,
        iterations: int = 20,
        point_to_plane: bool = False,
        target_normals: Optional[torch.Tensor] = None,
        tile: int = 2048,
        damping: float = 1e-6,
        correspondence: str = "exact",
        window: int = 64) -> IcpResult:
    """Align ``source`` (N, 3) to ``target`` (M, 3), both on one device in
    one float dtype; ``*_valid`` mask padded rows.

    ``correspondence``: ``"exact"`` — brute-force nearest neighbour,
    O(N·M) per iteration; ``"morton"`` — Morton-window matching,
    O((N+M)·window) per iteration (:func:`morton_nearest_target`).
    Point-to-plane composes with both: without ``target_normals`` the
    Morton path fits them with the K6 window fit
    (``_morton_window_normals(target, valid, 10, max(window, 32))``), the
    exact path with exact 16-NN normals, once per call.  On float32
    tensors the exact path's iterations are K8's (on CUDA its launches and
    nothing else); the result's rotation and translation then view one
    pose buffer.

    Example — recover a known 5 cm shift:

    >>> import torch
    >>> g = torch.Generator().manual_seed(0)
    >>> target = torch.rand((256, 3), generator=g) * 5
    >>> source = target + torch.tensor([0.05, 0.0, -0.05])
    >>> result = icp(source, target, iterations=10)
    >>> torch.allclose(result.translation, torch.tensor([-0.05, 0.0, 0.05]),
    ...                atol=1e-3)
    True
    """
    dtype, dev = source.dtype, source.device
    if source_valid is None:
        source_valid = torch.ones(source.shape[0], dtype=torch.bool,
                                  device=dev)
    if target_valid is None:
        target_valid = torch.ones(target.shape[0], dtype=torch.bool,
                                  device=dev)
    if correspondence not in ("exact", "morton"):
        raise ValueError(f"unknown correspondence {correspondence!r}")
    rot = torch.eye(3, dtype=dtype, device=dev) if init_rotation is None \
        else init_rotation.to(dtype)
    t = torch.zeros(3, dtype=dtype, device=dev) if init_translation is None \
        else init_translation.to(dtype)
    if point_to_plane:
        if target_normals is None:
            if correspondence == "morton":
                target_normals, _ = _morton_window_normals(
                    target, target_valid, 10, max(window, 32))
            else:
                with fp32_matmul():
                    target_normals, _ = _normals_device(
                        target, target_valid, 16, tile)
        target_normals = target_normals.to(dtype)

    max_d2 = max_correspondence_distance ** 2
    if correspondence == "exact" and dtype == torch.float32:
        pose = torch.cat([rot.reshape(9), t])
        rmse, nin = icp_iterate(
            source.contiguous(), source_valid.to(torch.bool).contiguous(),
            target.contiguous(), target_valid.to(torch.bool).contiguous(),
            target_normals.contiguous() if point_to_plane else None, pose,
            max_d2, point_to_plane, damping, iterations)
        return IcpResult(pose[:9].view(3, 3), pose[9:], rmse, nin,
                         iterations)
    if not point_to_plane:
        target_normals = torch.zeros_like(target)

    if correspondence == "exact":
        def corr_fn(moved):
            idx, d2 = _nearest(moved, target, target_valid, tile)
            return target[idx], d2, target_normals[idx]
    else:
        tmin, tmax = _valid_extent(target, target_valid)
        extent = tmax - tmin
        zero_n = torch.zeros_like(source)

        def corr_fn(moved):
            if point_to_plane:
                return morton_nearest_target(
                    moved, source_valid, target, target_valid, tmin, extent,
                    window, target_normals=target_normals)
            matched, d2 = morton_nearest_target(
                moved, source_valid, target, target_valid, tmin, extent,
                window)
            return matched, d2, zero_n

    rmse = nin = torch.zeros((), dtype=dtype, device=dev)
    with fp32_matmul():             # the distance and normal-equation products
        for _ in range(iterations):
            rot, t, rmse, nin = _icp_step(source, source_valid, corr_fn,
                                          rot, t, max_d2, point_to_plane,
                                          damping)
    return IcpResult(rot, t, rmse, nin.to(torch.int32), iterations)
