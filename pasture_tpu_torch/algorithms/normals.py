"""Normal estimation (parity: pasture-algorithms/src/normal_estimation.rs).

Port of pasture_tpu/algorithms/normals.py.  Normal = eigenvector of the
smallest eigenvalue of the k-neighbourhood covariance, curvature =
``|λ₀ / (λ₀+λ₁+λ₂)|``, normals unoriented.

Two paths:

* exact (up to 65 536 points): brute-force k-NN as tiled fp32 distance
  matmuls plus ``torch.topk``, a gather, covariances and a closed-form
  symmetric 3x3 eigensolve;
* Morton window (any size): both Morton curves' sorted orders, the k
  nearest of each row's ±``window`` rank neighbours selected and fitted
  by the K6 kernel (:func:`window_fit`), rows brought back to input order
  by a scatter.

The JAX package's scan-tiled exact path above 65 536 points
(``_normals_scan_exact``) is not ported yet: ``method="exact"`` there
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .._device import fp32_matmul, resolve_device
from ..buffers.device import PointBatch
from ..buffers.host import HostPointBuffer
from ..layout import attributes as att
from ..math.morton import morton_encode_dual32
from ..ops.kernels.window_fit_kernel import (window_fit_moments,
                                             window_fit_moments_plain)

__all__ = ["compute_normals", "knn_indices", "compute_centroid",
           "window_fit"]

#: ``chip_smoke.py`` sets this to run :func:`window_fit` on the kernel's
#: plain version on CUDA tensors too, to hold the whole path against it
_PLAIN_WINDOW_FIT = False

_INVALID_KEY = torch.iinfo(torch.int64).max


def compute_centroid(buffer: Union[HostPointBuffer, PointBatch]
                     ) -> np.ndarray:
    """Mean position in f64 (reference ``compute_centroid``,
    normal_estimation.rs:198)."""
    if isinstance(buffer, PointBatch):
        n = int(buffer.count.item())
        pos = buffer.data[att.POSITION_3D.name][:n].cpu().numpy()
    else:
        pos = buffer.get_converted(att.POSITION_3D)
    return pos.astype(np.float64).mean(axis=0)


def _knn_tile(query: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
              k: int) -> torch.Tensor:
    """k nearest of each query row among ``points``: one (Q, N) distance
    matrix by a matmul (the caller holds :func:`fp32_matmul`), then
    ``torch.topk``."""
    q2 = torch.sum(query * query, dim=1, keepdim=True)
    p2 = torch.sum(points * points, dim=1)[None, :]
    d2 = q2 + p2 - 2.0 * (query @ points.T)
    d2 = torch.where(valid[None, :], d2, torch.full_like(d2, float("inf")))
    return torch.topk(d2, k, dim=1, largest=False).indices


def knn_indices(positions: torch.Tensor, valid: torch.Tensor, k: int,
                tile: int = 2048) -> torch.Tensor:
    """(N, k) int64 indices of the k nearest neighbours, nearest first (self
    included, as in the reference's kd-tree query).  Tiled over queries to
    bound the distance matrix at ``tile x N``; the distance products run in
    true fp32.  The order among equal distances is unspecified."""
    with fp32_matmul():
        return _knn(positions, valid, k, tile)


def _knn(positions, valid, k, tile):
    return torch.cat([_knn_tile(positions[i:i + tile], positions, valid, k)
                      for i in range(0, positions.shape[0], tile)])


def _det3(b: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices by cofactors (elementwise work,
    no factorisation)."""
    return (b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2]
                            - b[..., 1, 2] * b[..., 2, 1])
            - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2]
                              - b[..., 1, 2] * b[..., 2, 0])
            + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1]
                              - b[..., 1, 1] * b[..., 2, 0]))


def _eigh3_smallest(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest eigenvalue + eigenvector of symmetric 3x3 matrices
    (..., 3, 3) by the trigonometric closed form (the reference's
    characteristic-polynomial solve, normal_estimation.rs:308-455)."""
    a = cov
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    tr = a.diagonal(dim1=-2, dim2=-1).sum(-1)
    q = tr / 3.0
    a_q = a - q[..., None, None] * eye
    p2 = torch.sum(a_q * a_q, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    b = a_q / p[..., None, None]
    phi = torch.arccos(torch.clamp(_det3(b) / 2.0, -1.0, 1.0)) / 3.0
    # eigenvalues q + 2p cos(phi + 2πk/3), k=0 largest .. smallest
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0)   # smallest
    lam2 = q + 2.0 * p * torch.cos(phi)                        # largest
    lam1 = tr - lam0 - lam2

    # eigenvector of lam0: columns of (A - lam1 I)(A - lam2 I), the product
    # as one broadcast multiply and a sum (a batched 3x3 matmul is dozens of
    # library launches on millions of rows)
    b1 = a - lam1[..., None, None] * eye
    b2 = a - lam2[..., None, None] * eye
    m = torch.sum(b1[..., :, :, None] * b2[..., None, :, :], dim=-2)
    best = torch.argmax(torch.linalg.vector_norm(m, dim=-2), dim=-1)
    vec = torch.where((best == 0)[..., None], m[..., 0],
                      torch.where((best == 1)[..., None], m[..., 1],
                                  m[..., 2]))
    nrm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    # degenerate (isotropic) neighbourhoods: fall back to +z like a plane
    fallback = torch.zeros_like(vec)
    fallback[..., 2] = 1.0
    vec = torch.where(nrm > 1e-20, vec / torch.clamp_min(nrm, 1e-30),
                      fallback)
    return lam0, vec


def _curvature(cov: torch.Tensor, lam0: torch.Tensor) -> torch.Tensor:
    tr = cov.diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.where(tr != 0.0, torch.abs(lam0 / tr), torch.zeros_like(tr))


def _normals_device(pos: torch.Tensor, valid: torch.Tensor, k: int,
                    tile: int = 2048):
    """Exact k-NN normals: (normal (N, 3), curvature (N,)).  The caller
    holds :func:`fp32_matmul`."""
    idx = _knn(pos, valid, k, tile)
    neigh = pos[idx]                                  # (N, k, 3)
    centered = neigh - torch.mean(neigh, dim=1, keepdim=True)
    cov = centered.mT @ centered / k
    lam0, normal = _eigh3_smallest(cov)
    return normal, _curvature(cov, lam0)


def window_fit(sp: torch.Tensor, pp: torch.Tensor, k: int, w: int):
    """Plane-fit each row of ``sp`` (N, 3) against the ±``w`` window of the
    padded Morton-sorted array ``pp`` ((N + 2w, 3); row ``i`` of ``sp``
    aligns with row ``i + w`` of ``pp``; non-candidate rows are ``inf``).

    The k nearest of the 2w + 1 candidates (ties admitted, by the K6
    kernel's threshold with its 1e-6 margin) give the neighbourhood; its
    mean and covariance come from the kernel's query-frame moments.
    Returns ``(normal (N, 3), curvature (N,), tightness (N,) = mean selected
    d²)``.  On a CUDA tensor this is the K6 kernel, on a CPU tensor its
    plain version."""
    fit = window_fit_moments_plain if _PLAIN_WINDOW_FIT \
        else window_fit_moments
    cnt, tight_sum, s1, m6 = fit(sp, pp, k, w)
    c = torch.clamp_min(cnt, 1.0)
    mu = s1 / c[:, None]
    mm = m6 / c[:, None]
    xx = mm[:, 0] - mu[:, 0] * mu[:, 0]
    yy = mm[:, 1] - mu[:, 1] * mu[:, 1]
    zz = mm[:, 2] - mu[:, 2] * mu[:, 2]
    xy = mm[:, 3] - mu[:, 0] * mu[:, 1]
    xz = mm[:, 4] - mu[:, 0] * mu[:, 2]
    yz = mm[:, 5] - mu[:, 1] * mu[:, 2]
    cov = torch.stack([torch.stack([xx, xy, xz], dim=-1),
                       torch.stack([xy, yy, yz], dim=-1),
                       torch.stack([xz, yz, zz], dim=-1)], dim=-2)
    lam0, normal = _eigh3_smallest(cov)
    return normal, _curvature(cov, lam0), tight_sum / c


def morton_order(pos: torch.Tensor, valid: torch.Tensor,
                 origin: torch.Tensor, extent: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows along the 60-bit Morton curve of an
    isotropic 20-bit grid anchored at ``origin`` with cell ``extent / 2**20``
    — one stable sort of the packed key ``hi << 30 | lo``; invalid rows sort
    last."""
    cell = torch.clamp((pos - origin[None, :]) / extent * (1 << 20),
                       0, (1 << 20) - 1).to(torch.int64)
    hi, lo = morton_encode_dual32(cell[:, 0], cell[:, 1], cell[:, 2])
    key = torch.where(valid, (hi << 30) | lo,
                      torch.full_like(hi, _INVALID_KEY))
    return torch.sort(key, stable=True).indices


def _valid_extent(pos: torch.Tensor, valid: torch.Tensor):
    """(min, max) of the valid rows per axis."""
    inf = torch.full_like(pos, float("inf"))
    return (torch.where(valid[:, None], pos, inf).amin(dim=0),
            torch.where(valid[:, None], pos, -inf).amax(dim=0))


def _morton_window_normals(pos: torch.Tensor, valid: torch.Tensor, k: int,
                           window: int):
    """Scalable approximate normals: Morton-window k-NN.

    Per curve: sort rows along the Morton curve, fit each row against its
    ±``window`` rank neighbours (K6), scatter the results back to input
    order.  Two curves with origins staggered by a third of the extent; per
    point the fit of the tighter neighbourhood wins (a point at an octant
    boundary of one curve is interior on the other).  A neighbour outside
    the window is missed: normals are plane fits and robust to that."""
    n = pos.shape[0]
    pmin, pmax = _valid_extent(pos, valid)
    # isotropic cells: a per-axis scale would stretch a thin axis (a
    # terrain's z) across the whole cell range and break locality
    extent = torch.clamp_min(torch.max(pmax - pmin), 1e-9)
    w = window

    def one_curve(origin):
        perm = morton_order(pos, valid, origin, extent)
        sp = pos[perm]
        svalid = valid[perm]
        pad = torch.full((w, 3), float("inf"), dtype=pos.dtype,
                         device=pos.device)
        pp = torch.cat([pad, torch.where(svalid[:, None], sp,
                                         torch.full_like(sp, float("inf"))),
                        pad])
        normal, curvature, tight = window_fit(sp, pp, k, w)
        out_n = torch.empty_like(normal)
        out_n[perm] = normal
        out_c = torch.empty_like(curvature)
        out_c[perm] = curvature
        out_t = torch.empty_like(tight)
        out_t[perm] = tight
        return out_n, out_c, out_t

    n_a, c_a, t_a = one_curve(pmin)
    n_b, c_b, t_b = one_curve(pmin - extent / 3.0)
    use_a = t_a <= t_b
    return (torch.where(use_a[:, None], n_a, n_b),
            torch.where(use_a, c_a, c_b))


#: point count above which ``auto`` switches to the Morton-window path
_EXACT_NORMALS_MAX = 1 << 16


def compute_normals(buffer: Union[HostPointBuffer, PointBatch], k_nn: int,
                    tile: int = 2048, method: str = "auto",
                    window: int = 64,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point (normals (N, 3), curvature (N,)) as numpy.

    ``method``: ``"exact"`` — brute-force k-NN (up to 65 536 points; above
    that the scan-tiled exact path is not ported yet and this raises
    ``NotImplementedError``); ``"morton"`` — Morton-window approximate
    k-NN on the K6 kernel (:func:`_morton_window_normals`); ``"auto"``
    (default) — exact up to 65 536 points, morton above.

    A host buffer goes to ``device`` (``None``: the GPU, raising without
    one) as float32; a :class:`PointBatch` is computed where it lives, in
    its position column's dtype.  Raises like the reference for clouds of
    fewer than 3 points or ``k_nn < 3`` (normal_estimation.rs:86-92)."""
    if isinstance(buffer, PointBatch):
        n = int(buffer.count.item())
        pos = buffer.data[att.POSITION_3D.name]
        valid = buffer.valid_mask()
    else:
        dev = resolve_device(device)
        n = len(buffer)
        pos = torch.from_numpy(np.ascontiguousarray(
            buffer.get_converted(att.POSITION_3D), dtype=np.float32)).to(dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    if n < 3:
        raise ValueError("The point cloud is too small. Please use a point "
                         "cloud that has 3 or more points!")
    if k_nn < 3:
        raise ValueError("The k nearest neighbors attribute is too small!")
    if method not in ("auto", "exact", "morton"):
        raise ValueError(f"unknown method {method!r}")
    if method == "auto":
        method = "exact" if n <= _EXACT_NORMALS_MAX else "morton"
    if method == "morton":
        if window < k_nn:
            raise ValueError(f"window ({window}) must be >= k_nn ({k_nn})")
        normal, curvature = _morton_window_normals(pos, valid, k_nn, window)
    elif n <= _EXACT_NORMALS_MAX:
        with fp32_matmul():
            normal, curvature = _normals_device(pos, valid, k_nn, tile)
    else:
        raise NotImplementedError(
            f"exact normals above {_EXACT_NORMALS_MAX} points (the JAX "
            f"package's scan-tiled _normals_scan_exact) are not ported yet; "
            f"use method='morton'")
    return normal[:n].cpu().numpy(), curvature[:n].cpu().numpy()
