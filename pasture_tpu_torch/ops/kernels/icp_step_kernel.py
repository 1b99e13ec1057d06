"""K8 — one exact-correspondence ICP iteration as two launches.

K8a ``icp_correspond_accumulate`` moves each valid source row by the pose
held in a device buffer, finds its exact nearest valid target row (direct
``(q - p)·(q - p)`` in float32, the first index on a tie) and sums the
Gauss-Newton terms of the inliers (``d² < max_d2``) into partials of 8
queries; K8b ``icp_solve_update`` (one block) reduces the partials, solves
the damped 6x6 system by Cholesky and composes the pose with
``se3_exp(-x)`` in place, writing the rmse and the inlier count of the
iteration.  :func:`icp_iterate` runs the whole loop, ``iterations`` x (K8a,
K8b), from one host call with no read back between launches.

Replaces no TPU kernel: the JAX package leaves this loop to XLA.  It was
added because the port's eager loop issued ~186 small operations an
iteration and the odometry cell's time was their launches.

Bound on the H100 (K8a): instruction issue, ~8 operations a pair (3
differences, 3 squares, 2 sums) plus a compare and a select; the bytes are
the two clouds, read once a block from L2.  Design (``csrc/icp_step.cu``):
a warp owns ``qpw`` consecutive queries, held in registers by all 32 lanes;
the block's 256 threads copy 2048 target rows at a time into shared memory
(x, y, z planes, ``inf`` where a row is invalid) and lane l scans rows
l, l + 32, ... for all the warp's queries, so a shared-memory load serves
``qpw`` pairs with no bank conflict.  The target range is split across the
lanes of a warp, not across blocks, so the merge of a query's 32 minima is
five shuffles and needs no second pass.  ``qpw`` follows the query count
(:func:`queries_per_warp`): one query a warp fills the card at the odometry
cell's 2.4 k queries (300 blocks for 132 SMs, 14 µs); at a million, eight
a warp cut the L2 traffic and the per-pair loads (483 ms, 27 % of the
operations' bound; one a warp: 656 ms).

Numbers: the residual and Jacobian are float32 as in the eager loop, their
products are taken in float64 (exactly) and every sum is float64, in a
fixed order (8 queries a partial from +0.0; K8b's lane l takes partials l,
l + 32, ... and the 32 lane sums meet in a butterfly), so the result is the
same run to run, with no atomics.  K8b solves in float64 and evaluates
``se3_exp``'s coefficients as Taylor series in θ² for θ < 2 (se3.py's
small-angle branch to every float digit below 1e-8, no cancellation of
``1 - cos θ`` above it), from sin and cos beyond.  The plain version here
repeats every rounding in the same order, so on the card K8 equals it bit
for bit, except a step of θ ≥ 2 rad, where CUDA's sin and cos and the
host's may differ in the last bit (``tests/test_torch_icp_step.py`` holds a
model of the kernel's schedule to the plain version).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from . import _build

__all__ = ["icp_correspond_accumulate", "icp_solve_update", "icp_iterate",
           "icp_correspond_accumulate_plain", "icp_solve_update_plain",
           "nearest_direct", "solve_pose", "queries_per_warp",
           "partial_count", "LAUNCHES", "TERMS"]

#: launches of each kernel on CUDA tensors
LAUNCHES = {"icp_correspond_accumulate": 0, "icp_solve_update": 0}

TERMS = 29          # H's 21 upper entries row by row, b's 6, count, sum d2
SUMQ = 8            # queries a K8a partial sums
WARPS = 8           # warps of a K8a block
LANES = 32
SERIES = 13         # Taylor terms of se3_exp's coefficients
SERIES_BELOW = 4.0  # θ² under which the series are used
QPW = (1, 8)        # the kernel's instances: queries a warp

#: (-1)^k / (2k + 1)!, (-1)^k / (2k + 2)!, (-1)^k / (2k + 3)!: the
#: coefficients of sin θ / θ, (1 - cos θ) / θ² and (θ - sin θ) / θ³ in θ²
#: (the kernel holds the same doubles as hex literals)
SERIES_A = tuple((-1) ** k / math.factorial(2 * k + 1) for k in range(SERIES))
SERIES_B = tuple((-1) ** k / math.factorial(2 * k + 2) for k in range(SERIES))
SERIES_C = tuple((-1) ** k / math.factorial(2 * k + 3) for k in range(SERIES))

_INDEX_MAX = (1 << 31) - 1


def queries_per_warp(n: int) -> int:
    """K8a's queries a warp for ``n`` queries: one up to 65 536 queries,
    else eight.  Measured on the card (H100, cold L2) with instances of 1,
    2, 4 and 8: at 2 400 x 2 400, 13.9 / 14.2 / 15.6 / 23.7 µs; at
    1 048 576 x 1 048 576, 655.8 / 533.4 / 500.7 / 482.9 ms."""
    return 1 if n <= 1 << 16 else 8


def partial_count(n: int, qpw: int) -> int:
    """Columns of K8a's partials: one per 8 queries of every block."""
    per = WARPS * qpw
    return -(-n // per) * qpw


# ---- the plain version ------------------------------------------------------

def _moved_plain(source: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """``R p + t`` row by row as the kernel rounds it:
    ((r0 px + r1 py) + r2 pz) + t."""
    r = pose.to(source.dtype)
    px, py, pz = source.unbind(1)
    return torch.stack([r[3 * i] * px + r[3 * i + 1] * py + r[3 * i + 2] * pz
                        + r[9 + i] for i in range(3)], dim=1)


def nearest_direct(query: torch.Tensor, target: torch.Tensor,
                   target_valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices int64, squared distances) of the nearest valid target row
    of each query row by the direct ``((dx² + dy²) + dz²)``, ``dx = target -
    query``; the first index wins a tie; ``inf`` where no target is valid.
    Tiled over the queries so no distance block exceeds 2**26 entries on
    CUDA, 2**22 on the CPU (the rows are independent: the tile changes no
    bit)."""
    m = target.shape[0]
    tile = max(1, (1 << (26 if query.is_cuda else 22)) // max(m, 1))
    tx, ty, tz = (c[None, :] for c in target.unbind(1))
    inf = torch.tensor(float("inf"), dtype=query.dtype, device=query.device)
    idx, d2 = [], []
    for i in range(0, query.shape[0], tile):
        qx, qy, qz = (c[:, None] for c in query[i:i + tile].unbind(1))
        dx, dy, dz = tx - qx, ty - qy, tz - qz
        d = dx * dx + dy * dy + dz * dz
        d = torch.where(target_valid[None, :], d, inf)
        best = torch.argmin(d, dim=1)
        idx.append(best)
        d2.append(torch.gather(d, 1, best[:, None])[:, 0])
    return torch.cat(idx), torch.cat(d2)


def _query_terms(moved, source_valid, idx, d2, target, normals, max_d2,
                 point_to_plane) -> torch.Tensor:
    """(n, 29) float64: each query's terms, +0.0 where it is no inlier."""
    f64 = torch.float64
    inlier = source_valid & (d2 < torch.tensor(max_d2, dtype=d2.dtype,
                                               device=d2.device))
    mx, my, mz = moved.unbind(1)
    qx, qy, qz = target[idx].unbind(1)
    ex, ey, ez = mx - qx, my - qy, mz - qz
    cols = []
    if point_to_plane:
        nx, ny, nz = normals[idx].unbind(1)
        r = (ex * nx + ey * ny + ez * nz).to(f64)
        jac = [c.to(f64) for c in (nx, ny, nz, my * nz - mz * ny,
                                   mz * nx - mx * nz, mx * ny - my * nx)]
        cols += [jac[a] * jac[b] for a in range(6) for b in range(a, 6)]
        cols += [jac[a] * r for a in range(6)]
    else:
        zero = torch.zeros_like(mx, dtype=f64)
        one = torch.ones_like(mx, dtype=f64)
        x, y, z = mx.to(f64), my.to(f64), mz.to(f64)
        jac = [[one, zero, zero, zero, z, -y],
               [zero, one, zero, -z, zero, x],
               [zero, zero, one, y, -x, zero]]
        e = [ex.to(f64), ey.to(f64), ez.to(f64)]
        cols += [jac[0][a] * jac[0][b] + jac[1][a] * jac[1][b]
                 + jac[2][a] * jac[2][b]
                 for a in range(6) for b in range(a, 6)]
        cols += [jac[0][a] * e[0] + jac[1][a] * e[1] + jac[2][a] * e[2]
                 for a in range(6)]
    cols += [torch.ones_like(mx, dtype=f64), d2.to(f64)]
    terms = torch.stack(cols, dim=1)
    return torch.where(inlier[:, None], terms,
                       torch.zeros((), dtype=f64, device=terms.device))


def _partials_plain(terms: torch.Tensor, parts: int) -> torch.Tensor:
    """(29, parts): query 8p..8p+7's terms summed in ascending order from
    +0.0 (the rows past n are +0.0)."""
    pad = parts * SUMQ - terms.shape[0]
    terms = torch.cat([terms, terms.new_zeros((pad, TERMS))])
    rows = terms.view(parts, SUMQ, TERMS)
    acc = terms.new_zeros((parts, TERMS))
    for k in range(SUMQ):
        acc = acc + rows[:, k]
    return acc.T.contiguous()


def icp_correspond_accumulate_plain(source, source_valid, target,
                                    target_valid, normals, pose, max_d2,
                                    point_to_plane, qpw=None
                                    ) -> torch.Tensor:
    """Plain PyTorch version of :func:`icp_correspond_accumulate`, equal to
    the kernel bit for bit."""
    n = source.shape[0]
    qpw = qpw or queries_per_warp(n)
    moved = _moved_plain(source, pose)
    idx, d2 = nearest_direct(moved, target, target_valid)
    terms = _query_terms(moved, source_valid, idx, d2, target, normals,
                         max_d2, point_to_plane)
    return _partials_plain(terms, partial_count(n, qpw))


def _column_sums(partial: torch.Tensor) -> List[float]:
    """K8b's 29 sums: lane l adds partials l, l + 32, ... in order from +0.0,
    then the butterfly as lane 0 sees it."""
    parts = partial.shape[1]
    pad = -(-parts // LANES) * LANES - parts
    cols = torch.cat([partial.to(torch.float64),
                      partial.new_zeros((TERMS, pad), dtype=torch.float64)],
                     dim=1).view(TERMS, -1, LANES)
    s = cols.new_zeros((TERMS, LANES))
    for r in range(cols.shape[1]):
        s = s + cols[:, r]
    o = LANES // 2
    while o:
        s = s[:, :o] + s[:, o:2 * o]
        o //= 2
    return s[:, 0].tolist()


def _series(coef, x: float) -> float:
    acc = coef[-1]
    for c in reversed(coef[:-1]):
        acc = acc * x + c
    return acc


def solve_pose(sums: List[float], pose: List[float], damping: float
               ) -> Tuple[Optional[List[float]], float, int]:
    """K8b's arithmetic on host floats (IEEE doubles, each operation
    rounded once, as the kernel's): the new pose as 12 doubles (``None``
    where a pivot is not positive: the pose stays), the rmse and the
    inlier count."""
    h = [[0.0] * 6 for _ in range(6)]
    o = 0
    for a in range(6):
        for c in range(a, 6):
            h[a][c] = h[c][a] = sums[o]
            o += 1
    b = sums[21:27]
    for a in range(6):
        h[a][a] = h[a][a] + damping
    cnt = sums[27]
    rmse = math.sqrt(sums[28] / (cnt if cnt > 1.0 else 1.0))
    lo = [[0.0] * 6 for _ in range(6)]
    for j in range(6):
        s = h[j][j]
        for k in range(j):
            s = s - lo[j][k] * lo[j][k]
        if not s > 0.0:
            return None, rmse, int(cnt)
        lo[j][j] = math.sqrt(s)
        for i in range(j + 1, 6):
            v = h[i][j]
            for k in range(j):
                v = v - lo[i][k] * lo[j][k]
            lo[i][j] = v / lo[j][j]
    x = [0.0] * 6
    for i in range(6):
        v = b[i]
        for k in range(i):
            v = v - lo[i][k] * x[k]
        x[i] = v / lo[i][i]
    for i in range(5, -1, -1):
        v = x[i]
        for k in range(i + 1, 6):
            v = v - lo[k][i] * x[k]
        x[i] = v / lo[i][i]
    rho = [-x[0], -x[1], -x[2]]
    ph = [-x[3], -x[4], -x[5]]
    th2 = ph[0] * ph[0] + ph[1] * ph[1] + ph[2] * ph[2]
    if th2 < SERIES_BELOW:
        ca, cb, cc = (_series(SERIES_A, th2), _series(SERIES_B, th2),
                      _series(SERIES_C, th2))
    else:
        th = math.sqrt(th2)
        sn, cs = math.sin(th), math.cos(th)
        ca, cb, cc = sn / th, (1.0 - cs) / th2, (th - sn) / (th2 * th)
    kk = [[0.0, -ph[2], ph[1]], [ph[2], 0.0, -ph[0]], [-ph[1], ph[0], 0.0]]
    dr = [[0.0] * 3 for _ in range(3)]
    v3 = [[0.0] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            k2 = ph[i] * ph[j] - (th2 if i == j else 0.0)
            ident = 1.0 if i == j else 0.0
            dr[i][j] = ident + ca * kk[i][j] + cb * k2
            v3[i][j] = ident + cb * kk[i][j] + cc * k2
    out = [0.0] * 12
    for i in range(3):
        for j in range(3):
            out[3 * i + j] = (dr[i][0] * pose[j] + dr[i][1] * pose[3 + j]
                              + dr[i][2] * pose[6 + j])
        dt = v3[i][0] * rho[0] + v3[i][1] * rho[1] + v3[i][2] * rho[2]
        out[9 + i] = (dr[i][0] * pose[9] + dr[i][1] * pose[10]
                      + dr[i][2] * pose[11] + dt)
    return out, rmse, int(cnt)


def icp_solve_update_plain(partial: torch.Tensor, pose: torch.Tensor,
                           damping: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`icp_solve_update`: updates ``pose`` in place
    and returns ``(rmse, num_inliers)``, equal to the kernel bit for bit."""
    new, rmse, nin = solve_pose(_column_sums(partial), pose.tolist(),
                                float(damping))
    if new is not None:
        pose.copy_(torch.tensor(new, dtype=torch.float64).to(pose.dtype))
    return (torch.tensor(rmse, dtype=torch.float64).to(
                torch.float32).to(pose.device),
            torch.tensor(nin, dtype=torch.int32, device=pose.device))


# ---- the kernels ------------------------------------------------------------

def _check(source, source_valid, target, target_valid, normals, pose,
           point_to_plane) -> Tuple[int, int]:
    """What the kernels take; raises ``ValueError`` on anything else."""
    if source.ndim != 2 or source.shape[1] != 3 or target.ndim != 2 \
            or target.shape[1] != 3:
        raise ValueError(f"source and target must be (n, 3) and (m, 3), got "
                         f"{tuple(source.shape)} and {tuple(target.shape)}")
    n, m = source.shape[0], target.shape[0]
    want = [("source", source, torch.float32, (n, 3)),
            ("source_valid", source_valid, torch.bool, (n,)),
            ("target", target, torch.float32, (m, 3)),
            ("target_valid", target_valid, torch.bool, (m,)),
            ("pose", pose, torch.float32, (12,))]
    if point_to_plane:
        if normals is None:
            raise ValueError("point-to-plane needs target normals")
        want.append(("normals", normals, torch.float32, (m, 3)))
    for name, t, dtype, shape in want:
        if t.device != source.device:
            raise ValueError(f"{name} is on {t.device}, source on "
                             f"{source.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= n <= _INDEX_MAX // 3 or not 1 <= m <= _INDEX_MAX // 3:
        raise ValueError(f"the kernels take 1 to {_INDEX_MAX // 3} rows a "
                         f"cloud, got n={n}, m={m}")
    return n, m


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def icp_correspond_accumulate(source: torch.Tensor,
                              source_valid: torch.Tensor,
                              target: torch.Tensor,
                              target_valid: torch.Tensor,
                              normals: Optional[torch.Tensor],
                              pose: torch.Tensor, max_d2: float,
                              point_to_plane: bool,
                              qpw: Optional[int] = None) -> torch.Tensor:
    """K8a once: the (29, parts) float64 partials of the Gauss-Newton
    terms of ``source`` (n, 3) moved by ``pose`` (12,: R row-major, then
    t) against ``target`` (m, 3); ``normals`` (m, 3) for point-to-plane.

    On CUDA tensors the kernel (float32, bool masks, contiguous, else
    ``ValueError``); on CPU tensors the plain version."""
    if not source.is_cuda:
        return icp_correspond_accumulate_plain(
            source, source_valid, target, target_valid, normals, pose,
            max_d2, point_to_plane, qpw)
    n, m = _check(source, source_valid, target, target_valid, normals, pose,
                  point_to_plane)
    qpw = qpw or queries_per_warp(n)
    if qpw not in QPW:
        raise ValueError(f"qpw must be one of {QPW}, got {qpw}")
    parts = partial_count(n, qpw)
    partial = torch.empty((TERMS, parts), dtype=torch.float64,
                          device=source.device)
    lib = _build.library("icp_step")
    with torch.cuda.device(source.device):
        code = lib.icp_correspond_launch(
            source.data_ptr(), source_valid.data_ptr(), n, target.data_ptr(),
            target_valid.data_ptr(), _ptr(normals if point_to_plane else None),
            m, pose.data_ptr(), max_d2, int(point_to_plane),
            partial.data_ptr(), parts, qpw, _build.stream())
    _build.check(code, "icp_correspond_accumulate")
    LAUNCHES["icp_correspond_accumulate"] += 1
    return partial


def icp_solve_update(partial: torch.Tensor, pose: torch.Tensor,
                     damping: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8b once: the damped step of the summed ``partial`` composed into
    ``pose`` in place; returns ``(rmse, num_inliers)`` (0-d float32, 0-d
    int32).  CPU tensors run the plain version."""
    if not partial.is_cuda:
        return icp_solve_update_plain(partial, pose, damping)
    if partial.dtype != torch.float64 or partial.ndim != 2 \
            or partial.shape[0] != TERMS or not partial.is_contiguous():
        raise ValueError(f"partial must be contiguous float64 (29, parts), "
                         f"got {partial.dtype} {tuple(partial.shape)}")
    if pose.dtype != torch.float32 or tuple(pose.shape) != (12,) \
            or not pose.is_contiguous() or pose.device != partial.device:
        raise ValueError("pose must be a contiguous float32 (12,) on the "
                         "partials' device")
    rmse = torch.empty((), dtype=torch.float32, device=pose.device)
    nin = torch.empty((), dtype=torch.int32, device=pose.device)
    lib = _build.library("icp_step")
    with torch.cuda.device(pose.device):
        code = lib.icp_solve_launch(partial.data_ptr(), partial.shape[1],
                                    pose.data_ptr(), float(damping),
                                    rmse.data_ptr(), nin.data_ptr(),
                                    _build.stream())
    _build.check(code, "icp_solve_update")
    LAUNCHES["icp_solve_update"] += 1
    return rmse, nin


def icp_iterate(source: torch.Tensor, source_valid: torch.Tensor,
                target: torch.Tensor, target_valid: torch.Tensor,
                normals: Optional[torch.Tensor], pose: torch.Tensor,
                max_d2: float, point_to_plane: bool, damping: float,
                iterations: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iterations`` ICP steps, K8a then K8b each, updating ``pose`` in
    place; returns the last step's ``(rmse, num_inliers)`` (zeros for no
    step).  On CUDA tensors one host call launches them all and nothing is
    read back; on CPU tensors the plain version runs step by step."""
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    if iterations == 0:
        return (torch.zeros((), dtype=torch.float32, device=pose.device),
                torch.zeros((), dtype=torch.int32, device=pose.device))
    if not source.is_cuda:
        for _ in range(iterations):
            partial = icp_correspond_accumulate_plain(
                source, source_valid, target, target_valid, normals, pose,
                max_d2, point_to_plane)
            rmse, nin = icp_solve_update_plain(partial, pose, damping)
        return rmse, nin
    n, m = _check(source, source_valid, target, target_valid, normals, pose,
                  point_to_plane)
    qpw = queries_per_warp(n)
    parts = partial_count(n, qpw)
    dev = source.device
    partial = torch.empty((TERMS, parts), dtype=torch.float64, device=dev)
    rmse = torch.empty((), dtype=torch.float32, device=dev)
    nin = torch.empty((), dtype=torch.int32, device=dev)
    lib = _build.library("icp_step")
    with torch.cuda.device(dev):
        code = lib.icp_iterate_launch(
            source.data_ptr(), source_valid.data_ptr(), n, target.data_ptr(),
            target_valid.data_ptr(), _ptr(normals if point_to_plane else None),
            m, pose.data_ptr(), max_d2, int(point_to_plane), float(damping),
            partial.data_ptr(), parts, qpw, iterations, rmse.data_ptr(),
            nin.data_ptr(), _build.stream())
    _build.check(code, "icp_iterate")
    LAUNCHES["icp_correspond_accumulate"] += iterations
    LAUNCHES["icp_solve_update"] += iterations
    return rmse, nin
