"""Plain PyTorch reference of scan-to-keyframe odometry.

What one ``add_scan`` computes, worked out again from the raw scans:

* the keyframe's points: a voxel grid of ``voxel`` metres anchored at the
  scan's minimum, each point in ``floor`` of its float32 offset from that
  minimum, each voxel's point the float64 mean of its points;
* the relative pose of a scan to the keyframe before it: point-to-plane
  ICP from the identity, ``iterations`` Gauss-Newton steps, each point
  matched to its exact nearest target point, matches farther than
  ``max_distance`` left out, target normals from the exact ``k`` nearest
  targets (the point itself among them), the step damped by ``damping``.

``precision="float64"`` is the reference.  The control, which a correct
comparison has to reject, takes each in the precision below the stated
one: the ICP with ``precision="tf32"``, the same arithmetic in float32
with every matrix product's operands rounded to TF32's 10-bit mantissa,
as a TF32 tensor core rounds them; the keyframe points with
``precision="bfloat16"``.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Tuple

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa rounded to 10 bits (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return to_tf32(a) @ to_tf32(b)
    return a @ b


def _dtype(precision: str):
    return torch.float64 if precision == "float64" else torch.float32


def voxel_cells(points: torch.Tensor, anchor: torch.Tensor, voxel: float,
                dtype=torch.float32) -> torch.Tensor:
    """(n, 3) int64 cells of float64 ``points``: ``floor`` of the float32
    (or ``dtype``) offset from ``anchor`` over ``voxel``."""
    rel = (points - anchor).to(dtype)
    return torch.floor(rel / voxel).to(torch.int64)


def cell_code(cell: torch.Tensor) -> torch.Tensor:
    c = cell.to(torch.int64)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def downsample(points: torch.Tensor, voxel: float,
               precision: str = "float64"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codes, centroids)`` of a scan's voxels, ascending by code.  With
    ``precision="bfloat16"`` (the control of the keyframe points) the
    offsets and their means are bfloat16."""
    anchor = points.min(dim=0).values
    low = torch.bfloat16 if precision == "bfloat16" else torch.float32
    code = cell_code(voxel_cells(points, anchor, voxel, low))
    uniq, inv, counts = torch.unique(code, return_inverse=True,
                                     return_counts=True)
    if precision == "bfloat16":
        sums = torch.zeros((uniq.shape[0], 3), dtype=low,
                           device=points.device)
        sums.index_add_(0, inv, (points - anchor).to(low))
        return uniq, (sums / counts[:, None].to(low)).to(
            torch.float64) + anchor
    sums = torch.zeros((uniq.shape[0], 3), dtype=torch.float64,
                       device=points.device)
    sums.index_add_(0, inv, points.to(torch.float64))
    return uniq, sums / counts[:, None].to(torch.float64)


def _nearest(query, target, precision, tile=2048):
    """Index and squared distance of each query's nearest target."""
    t2 = (target * target).sum(dim=1)[None, :]
    idx, d2 = [], []
    for i in range(0, query.shape[0], tile):
        q = query[i:i + tile]
        d = (q * q).sum(dim=1, keepdim=True) + t2 \
            - 2.0 * _mm(q, target.T, precision)
        best = torch.argmin(d, dim=1)
        idx.append(best)
        d2.append(d.gather(1, best[:, None])[:, 0])
    return torch.cat(idx), torch.cat(d2)


def normals(points: torch.Tensor, k: int, precision: str, tile=2048
            ) -> torch.Tensor:
    """Unit normal of each point: the smallest eigenvector of the
    covariance of its ``k`` nearest points."""
    p2 = (points * points).sum(dim=1)[None, :]
    out = []
    for i in range(0, points.shape[0], tile):
        q = points[i:i + tile]
        d = (q * q).sum(dim=1, keepdim=True) + p2 \
            - 2.0 * _mm(q, points.T, precision)
        nb = points[torch.topk(d, k, dim=1, largest=False).indices]
        c = nb - nb.mean(dim=1, keepdim=True)
        cov = c.transpose(1, 2) @ c / k
        out.append(torch.linalg.eigh(cov.to(torch.float64)).eigenvectors[
            :, :, 0].to(points.dtype))
    return torch.cat(out)


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=v.dtype, device=v.device)
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def se3_exp(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twist ``[rho, phi]`` to ``(R, t)`` (Rodrigues; t = V rho)."""
    rho, phi = xi[:3], xi[3:]
    th = torch.linalg.norm(phi)
    k = _skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    if float(th) < 1e-12:
        return eye + k, rho
    a = torch.sin(th) / th
    b = (1 - torch.cos(th)) / th ** 2
    c = (th - torch.sin(th)) / th ** 3
    return eye + a * k + b * (k @ k), (eye + b * k + c * (k @ k)) @ rho


def icp(source: torch.Tensor, target: torch.Tensor, iterations: int,
        max_distance: float, k: int = 16, damping: float = 1e-6,
        precision: str = "float64") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(R, t)`` with ``R @ p + t`` taking float64 ``source`` points onto
    ``target``'s frame, from the identity.  Computed relative to the
    target's minimum."""
    dt = _dtype(precision)
    anchor = target.min(dim=0).values
    src = (source - anchor).to(dt)
    tgt = (target - anchor).to(dt)
    nrm = normals(tgt, k, precision)
    rot = torch.eye(3, dtype=dt, device=src.device)
    t = torch.zeros(3, dtype=dt, device=src.device)
    for _ in range(iterations):
        moved = src @ rot.T + t
        idx, d2 = _nearest(moved, tgt, precision)
        w = (d2 < max_distance ** 2).to(dt)
        n = nrm[idx]
        r = ((moved - tgt[idx]) * n).sum(dim=1)
        jac = torch.cat([n, torch.linalg.cross(moved, n)], dim=1)
        h = _mm((jac * w[:, None]).T, jac, precision) \
            + damping * torch.eye(6, dtype=dt, device=src.device)
        g = _mm((jac * w[:, None]).T, r[:, None], precision)[:, 0]
        xi = -torch.linalg.solve(h.to(torch.float64), g.to(torch.float64))
        d_rot, d_t = se3_exp(xi)
        rot = d_rot.to(dt) @ rot
        t = d_rot.to(dt) @ t + d_t.to(dt)
    rot64, t64 = rot.to(torch.float64), t.to(torch.float64)
    return rot64, t64 + anchor - rot64 @ anchor


def spawns_keyframe(rot: torch.Tensor, t: torch.Tensor,
                    keyframe_distance: float) -> bool:
    """The pipeline's rule: far enough, or turned at all."""
    return bool(torch.linalg.norm(t) >= keyframe_distance
                or torch.trace(rot) < 3.0 - 1e-3)
