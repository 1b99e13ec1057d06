"""Normal estimation (parity: pasture-algorithms/src/normal_estimation.rs).

Port of pasture_tpu/algorithms/normals.py.  Normal = eigenvector of the
smallest eigenvalue of the k-neighbourhood covariance, curvature =
``|λ₀ / (λ₀+λ₁+λ₂)|``, normals unoriented.

Three paths:

* exact up to 65 536 points: brute-force k-NN as tiled fp32 distance
  matmuls plus ``torch.topk``, a gather, covariances and a closed-form
  symmetric 3x3 eigensolve;
* exact above that (:func:`_normals_scan_exact`): a certified scan of
  Morton-ordered query tiles against Morton-ordered target blocks, nearest
  blocks first, stopping once no unvisited block can hold a k-NN; the
  neighbourhood moments are summed in each query's own frame;
* Morton window (any size): both Morton curves' sorted orders, the k
  nearest of each row's ±``window`` rank neighbours selected and fitted
  by the K6 kernel (:func:`window_fit`), rows brought back to input order
  by a scatter.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

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
    normal, curvature = _fit_moments(cnt, s1, m6)
    return normal, curvature, tight_sum / torch.clamp_min(cnt, 1.0)


def _fit_moments(cnt: torch.Tensor, s1: torch.Tensor, m6: torch.Tensor):
    """Normal and curvature of neighbourhoods given as query-frame moments:
    ``cnt`` (...,) points, ``s1`` (..., 3) their sum, ``m6`` (..., 6) the
    second moments xx, yy, zz, xy, xz, yz."""
    c = torch.clamp_min(cnt, 1.0)
    mu = s1 / c[..., None]
    mm = m6 / c[..., None]
    xx = mm[..., 0] - mu[..., 0] * mu[..., 0]
    yy = mm[..., 1] - mu[..., 1] * mu[..., 1]
    zz = mm[..., 2] - mu[..., 2] * mu[..., 2]
    xy = mm[..., 3] - mu[..., 0] * mu[..., 1]
    xz = mm[..., 4] - mu[..., 0] * mu[..., 2]
    yz = mm[..., 5] - mu[..., 1] * mu[..., 2]
    cov = torch.stack([torch.stack([xx, xy, xz], dim=-1),
                       torch.stack([xy, yy, yz], dim=-1),
                       torch.stack([xz, yz, zz], dim=-1)], dim=-2)
    lam0, normal = _eigh3_smallest(cov)
    return normal, _curvature(cov, lam0)


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


#: point count above which ``auto`` switches to the Morton-window path,
#: and ``exact`` from the gather path to :func:`_normals_scan_exact`
_EXACT_NORMALS_MAX = 1 << 16

#: query rows one call of :func:`_normals_scan_exact` takes from
#: ``compute_normals``: the slices bound one call's memory
_EXACT_SLICE = 1 << 18

#: distance entries (tiles x query_tile x chunk) one batched product of the
#: exact scan holds: 512 MB of float32 on the card, 64 MB on the CPU
_SCAN_ENTRIES = {"cuda": 1 << 27, "cpu": 1 << 24}

#: what :func:`_exact_scan` did since the caller last zeroed it: host syncs,
#: query tiles, those that summed whole blocks in pass 2, pass-1 block
#: visits and the most visits of one tile
SCAN_COUNTS = {"host_syncs": 0, "tiles": 0, "dense_tiles": 0, "visits": 0,
               "max_visits": 0}


@dataclasses.dataclass
class _Scan:
    """The exact scan's layout: Morton-sorted queries in tiles, targets in
    blocks, each tile's blocks in ascending order of their lower bound."""

    qperm: torch.Tensor     # (n,) query rows in sorted order
    q: torch.Tensor         # (tiles, query_tile, 3), the last tile padded
    p: torch.Tensor         # (blocks, chunk, 3), invalid rows zero
    qa: torch.Tensor        # (tiles, query_tile, 5): q, |q|², 1
    pa: torch.Tensor        # (blocks, chunk, 5): -2p, 1, |p|² (inf: invalid)
    lb: torch.Tensor        # (tiles, blocks) sorted lower bounds of d²
    order: torch.Tensor     # (tiles, blocks) block of each sorted bound


def _scan_layout(pos: torch.Tensor, valid: torch.Tensor, query_tile: int,
                 chunk: int, queries: Optional[torch.Tensor]) -> _Scan:
    """Sort targets (invalid last) and queries along one 20-bit isotropic
    Morton curve anchored at the valid minimum; cut targets into ``chunk``-
    row blocks with AABBs over their valid rows and queries into tiles of
    ``query_tile`` rows; bound d² from each tile's AABB to each block's."""
    qpos = pos if queries is None else queries
    n, nt = qpos.shape[0], pos.shape[0]
    inf = float("inf")
    chunk = min(chunk, 1 << max(11, (nt - 1).bit_length()))
    pmin, pmax = _valid_extent(pos, valid)
    extent = torch.clamp_min(torch.max(pmax - pmin), 1e-9)
    tperm = morton_order(pos, valid, pmin, extent)
    qperm = morton_order(qpos, torch.ones(n, dtype=torch.bool,
                                          device=pos.device), pmin, extent)
    padc = (-nt) % chunk
    tv = torch.nn.functional.pad(valid[tperm], (0, padc)).reshape(-1, chunk)
    tp = torch.nn.functional.pad(pos[tperm], (0, 0, 0, padc))
    tp = torch.where(tv.reshape(-1, 1), tp, 0.0).reshape(-1, chunk, 3)
    p2 = tp[..., 0] * tp[..., 0] + tp[..., 1] * tp[..., 1] \
        + tp[..., 2] * tp[..., 2]
    pa = torch.cat([-2.0 * tp, torch.ones_like(p2)[..., None],
                    torch.where(tv, p2, inf)[..., None]], dim=2)
    bmin = torch.where(tv[..., None], tp, inf).amin(dim=1)
    bmax = torch.where(tv[..., None], tp, -inf).amax(dim=1)
    qs = qpos[qperm]
    qs = torch.cat([qs, qs[-1:].expand((-n) % query_tile, 3)])
    q = qs.reshape(-1, query_tile, 3)
    q2 = q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1] + q[..., 2] * q[..., 2]
    tmin, tmax = q.amin(dim=1), q.amax(dim=1)
    gap = torch.clamp_min(torch.maximum(bmin[None] - tmax[:, None],
                                        tmin[:, None] - bmax[None]), 0.0)
    lb = gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1] \
        + gap[..., 2] * gap[..., 2]
    # inf - inf in the gap of an all-invalid block would be NaN: make it inf
    lb = torch.where(torch.isnan(lb), inf, lb)
    lb, order = torch.sort(lb, dim=1, stable=True)
    qa = torch.cat([q, q2[..., None], torch.ones_like(q2)[..., None]],
                   dim=2)
    return _Scan(qperm, q, tp, qa, pa, lb, order)


def _block_d2(scan: _Scan, tiles: torch.Tensor, blocks: torch.Tensor
              ) -> torch.Tensor:
    """d² = |q|² + |p|² - 2 q·p of each tile's queries against its block,
    (G, query_tile, chunk): one batched product of ``(q, |q|², 1)`` and
    ``(-2p, 1, |p|²)`` (the caller holds :func:`fp32_matmul`); invalid
    targets are inf through their |p|²."""
    return torch.bmm(scan.qa[tiles], scan.pa[blocks].mT)


def _exact_scan(pos: torch.Tensor, valid: torch.Tensor, k: int,
                query_tile: int = 1024, chunk: int = 8192,
                queries: Optional[torch.Tensor] = None,
                tiles: Optional[Sequence[int]] = None,
                exhaustive: bool = False):
    """The certified exact k-NN scan behind :func:`_normals_scan_exact`.

    Pass 1 keeps the smallest d² of each query over the blocks its tile
    visits, nearest bound first; ``thr`` is the k-th.  A tile stops as soon
    as its next block's bound exceeds the largest ``thr`` in the tile: no
    unvisited block holds a k-NN of any query in it.  Pass 2 walks the same
    order while the bound is at most that value and sums, in each query's
    own frame ``p - q``, every target with ``d² <= thr`` (all ties at the
    k-th distance) and finite d² (an under-full query, ``thr = inf``, takes
    every valid target and no padding).  Blocks past the certified prefix
    add exact zeros, so ``exhaustive=True``, which visits every block in
    the same order through the same code, gives the same bits.

    Pass 2 sums a block's selected targets only: the ``2k`` nearest of the
    block hold them all when pass 1 saw at most ``2k`` values ``<= thr``
    (its ``2k + 1``-th value is above ``thr``); they are summed in column
    order.  A tile where a query saw more (ties, ``thr = inf``) sums whole
    blocks instead.  Either way the summed vector of a (query, block) is
    the same in a certified and an exhaustive run.

    Each round, every tile still active loads its next block by a gather,
    ``G`` tiles to one batched product; ``G`` is fixed for the call and a
    short batch is padded with repeats, so every product and reduction has
    one shape and a tile's bits do not depend on its neighbours in the
    batch.  Pass 1 reads the active set on the host once a round, pass 2
    once in all.

    ``tiles``: run only these query tiles.  Returns ``(the query rows in
    sorted order (n,), thr (T, query_tile), normal (T, query_tile, 3),
    curvature (T, query_tile), pass-1 visits (T,) numpy)``, the last four
    over the tiles run in sorted query order.  The caller holds
    :func:`fp32_matmul`."""
    scan = _scan_layout(pos, valid, query_tile, chunk, queries)
    dev, dtype = pos.device, pos.dtype
    ntiles, nblocks = scan.lb.shape
    chunk = scan.p.shape[1]
    sel = torch.arange(ntiles, device=dev) if tiles is None \
        else torch.as_tensor(tiles, dtype=torch.int64, device=dev)
    t = sel.numel()
    lb, order = scan.lb[sel], scan.order[sel]
    group = max(1, min(t, _SCAN_ENTRIES.get(dev.type, 1 << 27)
                       // (query_tile * chunk)))
    near = min(2 * k, chunk)           # pass 2's candidates a block
    keep = min(near + 1, chunk)        # pass 1's values a query

    def batches(active: np.ndarray):
        """(row indices into the run's tiles, their count) per batch of G,
        the last padded with repeats of its last row."""
        for i in range(0, len(active), group):
            rows = active[i:i + group]
            m = len(rows)
            rows = np.concatenate([rows, np.repeat(rows[-1:], group - m)])
            yield torch.from_numpy(rows).to(dev), m

    def load(rows: torch.Tensor, r: int):
        blocks = order[rows, r]
        return _block_d2(scan, sel[rows], blocks), blocks

    # ---- pass 1: certified k-th distances -----------------------------------
    run = torch.full((t, query_tile, keep), float("inf"), dtype=dtype,
                     device=dev)
    visits = np.zeros(t, np.int64)
    active = np.arange(t)
    for r in range(nblocks):
        if len(active) == 0:
            break
        visits[active] += 1
        for rows, m in batches(active):
            d2, _ = load(rows, r)
            best = torch.topk(d2, keep, dim=2, largest=False).values
            merged = torch.topk(torch.cat([run[rows], best], dim=2), keep,
                                dim=2, largest=False).values
            run[rows[:m]] = merged[:m]
        if not exhaustive and r + 1 < nblocks:
            idx = torch.from_numpy(active).to(dev)
            go = lb[idx, r + 1] <= run[idx, :, k - 1].amax(dim=1)
            active = active[go.cpu().numpy()]
            SCAN_COUNTS["host_syncs"] += 1
    thr = run[:, :, k - 1]
    # every value <= thr is among the ``near`` nearest of its block
    sparse = (run[:, :, near] > thr).all(dim=1) if keep > near \
        else torch.zeros(t, dtype=torch.bool, device=dev)
    del run

    # ---- pass 2: moments over the same certified prefix ---------------------
    if exhaustive:
        prefix = np.full(t, nblocks)
        sparse = sparse.cpu().numpy()
    else:
        prefix = (lb <= thr.amax(dim=1)[:, None]).sum(dim=1)
        prefix, sparse = [a.cpu().numpy() for a in (prefix, sparse)]
        SCAN_COUNTS["host_syncs"] += 1
    cnt = torch.zeros((t, query_tile), dtype=dtype, device=dev)
    s1 = torch.zeros((t, query_tile, 3), dtype=dtype, device=dev)
    m6 = torch.zeros((t, query_tile, 6), dtype=dtype, device=dev)
    flat = scan.p.reshape(-1, 3)
    for r in range(int(prefix.max(initial=0))):
        for dense in (False, True):
            todo = np.flatnonzero((prefix > r) & (sparse != dense))
            for rows, m in batches(todo):
                d2, blocks = load(rows, r)
                q = scan.q[sel[rows]][:, :, None, :]
                lim = thr[rows][:, :, None]
                if not dense:
                    val, col = torch.topk(d2, near, dim=2, largest=False)
                    del d2
                    w = (val <= lim) & torch.isfinite(val)
                    # the selected columns first, in column order
                    col = torch.sort(torch.where(w, col, chunk), dim=2).values
                    w = col < chunk
                    p = flat[blocks[:, None, None] * chunk
                             + torch.clamp_max(col, chunk - 1)]
                else:
                    w = (d2 <= lim) & torch.isfinite(d2)
                    del d2
                    p = scan.p[blocks][:, None, :, :]
                dp = torch.where(w[..., None], p - q, 0.0)
                real = rows[:m]
                cnt[real] = cnt[real] + w.sum(dim=2)[:m].to(dtype)
                s1[real] = s1[real] + dp.sum(dim=2)[:m]
                m6[real] = m6[real] + torch.stack(
                    [(dp[..., a] * dp[..., b]).sum(dim=2)[:m] for a, b in
                     ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))],
                    dim=2)
    normal, curvature = _fit_moments(cnt, s1, m6)
    SCAN_COUNTS["tiles"] += t
    SCAN_COUNTS["dense_tiles"] += int((~sparse).sum())
    SCAN_COUNTS["visits"] += int(visits.sum())
    SCAN_COUNTS["max_visits"] = max(SCAN_COUNTS["max_visits"],
                                    int(visits.max(initial=0)))
    return scan.qperm, thr, normal, curvature, visits


def _normals_scan_exact(pos: torch.Tensor, valid: torch.Tensor, k: int,
                        query_tile: int = 1024, chunk: int = 8192,
                        queries: Optional[torch.Tensor] = None):
    """Exact k-NN normals at any size: ``(normal (n, 3), curvature (n,))``
    of every row of ``queries`` (default: every row of ``pos``, valid or
    not) against the valid rows of ``pos``, in input order (the certified
    scan :func:`_exact_scan`, its results scattered back through the sort
    permutation).  The caller holds :func:`fp32_matmul`."""
    qperm, _, normal, curvature, _ = _exact_scan(pos, valid, k, query_tile,
                                                 chunk, queries)
    n = qperm.shape[0]
    out_n = torch.empty((n, 3), dtype=normal.dtype, device=normal.device)
    out_n[qperm] = normal.reshape(-1, 3)[:n]
    out_c = torch.empty(n, dtype=curvature.dtype, device=curvature.device)
    out_c[qperm] = curvature.reshape(-1)[:n]
    return out_n, out_c


def compute_normals(buffer: Union[HostPointBuffer, PointBatch], k_nn: int,
                    tile: int = 2048, method: str = "auto",
                    window: int = 64,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point (normals (N, 3), curvature (N,)) as numpy.

    ``method``: ``"exact"`` — exact k-NN at any size (brute force up to
    65 536 points, the certified scan :func:`_normals_scan_exact` above,
    queries in slices of ``_EXACT_SLICE`` rows); ``"morton"`` —
    Morton-window approximate k-NN on the K6 kernel
    (:func:`_morton_window_normals`); ``"auto"`` (default) — exact up to
    65 536 points, morton above.

    A host buffer goes to ``device`` (``None``: the GPU, raising without
    one) as float32; a :class:`PointBatch` is computed where it lives, in
    its position column's dtype.  Raises like the reference for clouds of
    fewer than 3 points or ``k_nn < 3`` (normal_estimation.rs:86-92).

    Example — points on the z=0 plane get (unoriented) +-z normals and
    zero curvature:

    >>> import numpy as np
    >>> from pasture_tpu_torch.algorithms import compute_normals
    >>> from pasture_tpu_torch.buffers.host import HostPointBuffer
    >>> from pasture_tpu_torch.layout import attributes as att
    >>> from pasture_tpu_torch.layout.schema import PointSchema
    >>> rng = np.random.default_rng(0)
    >>> pos = np.concatenate([rng.uniform(0, 10, (64, 2)),
    ...                       np.zeros((64, 1))], axis=1)
    >>> buf = HostPointBuffer.from_columns(
    ...     PointSchema.from_attributes([att.POSITION_3D]),
    ...     {att.POSITION_3D.name: pos})
    >>> normals, curvature = compute_normals(buf, 8, device="cpu")
    >>> bool(np.allclose(np.abs(normals[:, 2]), 1.0, atol=1e-5))
    True
    >>> bool(np.allclose(curvature, 0.0, atol=1e-5))
    True
    """
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
        # queries in slices of _EXACT_SLICE rows, each against every target
        with fp32_matmul():
            parts = [_normals_scan_exact(pos, valid, k_nn,
                                         queries=pos[i:min(i + _EXACT_SLICE,
                                                           n)])
                     for i in range(0, n, _EXACT_SLICE)]
        normal = torch.cat([p[0] for p in parts])
        curvature = torch.cat([p[1] for p in parts])
    return normal[:n].cpu().numpy(), curvature[:n].cpu().numpy()
