"""RANSAC plane/line segmentation.

Parity with pasture-algorithms/src/segmentation.rs:1-459: ``Plane`` in
coordinate form ax+by+cz+d=0 built from 3 random points, ``Line`` from 2,
hypotheses ranked by inlier count (distance < threshold), best wins.

Port of pasture_tpu/algorithms/segmentation.py.  Host ``_serial``/``_par``
variants are the JAX package's numpy loop, bit for bit (same
``np.random.default_rng(seed).choice`` draws).  The device variants score
the whole hypothesis batch at once: all minimal subsets drawn up front,
distances of every point to every hypothesis in (128, point chunk)
blocks, inlier counts summed per hypothesis, the first maximum wins.

* The raw indices come from a CPU ``torch.Generator`` seeded by ``seed``,
  so a batch on the card and the same batch on the CPU score the same
  hypotheses.  Its stream is not JAX's ``randint`` stream: the same seed
  picks other hypotheses than the JAX package does.  Clashes inside a
  subset are then nudged apart as the JAX package does (:func:`_decollide`).
* Plane distances are an fp32 matmul per block, entered once per call in
  true fp32 (TF32 would move points across the threshold).
* The scorer's temporaries are bounded whatever N: at most
  128 hypotheses × ``_POINT_CHUNK[k]`` points at a time, 64 MiB of plane
  distances or 48 MiB per (128, points, 3) line tensor in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .._device import fp32_matmul, resolve_device
from ..buffers.device import PointBatch
from ..buffers.host import HostPointBuffer
from ..layout import attributes as att

__all__ = [
    "Plane", "Line",
    "ransac_plane_serial", "ransac_plane_par", "ransac_plane_device",
    "ransac_line_serial", "ransac_line_par", "ransac_line_device",
]


@dataclasses.dataclass
class Plane:
    """ax + by + cz + d = 0; ranking = inlier count (segmentation.rs:20-27)."""
    a: float
    b: float
    c: float
    d: float
    ranking: int = 0

    def distance(self, points: np.ndarray) -> np.ndarray:
        nrm = np.sqrt(self.a ** 2 + self.b ** 2 + self.c ** 2)
        return np.abs(points @ np.array([self.a, self.b, self.c])
                      + self.d) / nrm


@dataclasses.dataclass
class Line:
    """Line through two points; ranking = inlier count
    (segmentation.rs:12-17)."""
    first: np.ndarray
    second: np.ndarray
    ranking: int = 0

    def distance(self, points: np.ndarray) -> np.ndarray:
        d = self.second - self.first
        rel = self.first[None, :] - points
        return np.linalg.norm(np.cross(np.broadcast_to(d, rel.shape), rel),
                              axis=1) / np.linalg.norm(d)


def _positions(buffer) -> np.ndarray:
    if isinstance(buffer, PointBatch):
        n = int(buffer.count.item())
        return buffer.data[att.POSITION_3D.name][:n].cpu().numpy().astype(
            np.float64)
    return buffer.get_converted(att.POSITION_3D)


def _distinct_indices(rng, n: int, k: int) -> np.ndarray:
    return rng.choice(n, size=k, replace=False)


# ---- host variants -------------------------------------------------------------

def ransac_plane_serial(buffer, distance_threshold: float,
                        num_of_iterations: int, seed: int = 0
                        ) -> Tuple[Plane, np.ndarray]:
    """Best plane + inlier indices (reference ransac_plane_serial,
    segmentation.rs:239-255; inlier loop vectorised over points)."""
    pos = _positions(buffer)
    n = len(pos)
    if n < 3:
        raise ValueError("need at least 3 points for a plane")
    rng = np.random.default_rng(seed)
    best: Tuple[Plane, np.ndarray] = None
    for _ in range(num_of_iterations):
        i, j, k = _distinct_indices(rng, n, 3)
        normal = np.cross(pos[j] - pos[i], pos[k] - pos[i])
        d = -normal @ pos[i]
        plane = Plane(normal[0], normal[1], normal[2], d)
        dist = plane.distance(pos)
        inliers = np.flatnonzero(dist < distance_threshold)
        plane.ranking = len(inliers)
        if best is None or plane.ranking > best[0].ranking:
            best = (plane, inliers)
    return best


#: The reference's `_par` fans iterations over rayon (segmentation.rs:180-197);
#: the numpy loop is already vectorised over points, so par == serial here.
ransac_plane_par = ransac_plane_serial


def ransac_line_serial(buffer, distance_threshold: float,
                       num_of_iterations: int, seed: int = 0
                       ) -> Tuple[Line, np.ndarray]:
    """RANSAC line fit: returns the best :class:`Line` and its inlier
    indices after ``num_of_iterations`` two-point hypotheses (reference
    ``line_ransac_serial``, segmentation.rs; distances vectorised over
    the whole cloud per hypothesis)."""
    pos = _positions(buffer)
    n = len(pos)
    if n < 2:
        raise ValueError("need at least 2 points for a line")
    rng = np.random.default_rng(seed)
    best: Tuple[Line, np.ndarray] = None
    for _ in range(num_of_iterations):
        i, j = _distinct_indices(rng, n, 2)
        line = Line(pos[i], pos[j])
        dist = line.distance(pos)
        inliers = np.flatnonzero(dist < distance_threshold)
        line.ranking = len(inliers)
        if best is None or line.ranking > best[0].ranking:
            best = (line, inliers)
    return best


#: Parallel-hypothesis alias of :func:`ransac_line_serial` (the
#: reference's rayon variant, las_ransac.rs; the numpy implementation is
#: already vectorised over hypotheses, so both names share one function).
ransac_line_par = ransac_line_serial


# ---- device variants -----------------------------------------------------------

_HYPO_CHUNK = 128  # hypotheses per block; iterations round up to a multiple
#: points per block, by subset size: (128, 2**17) f32 plane distances,
#: (128, 2**15, 3) f32 line offsets and cross products
_POINT_CHUNK = {3: 1 << 17, 2: 1 << 15}


def _decollide(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Nudge clashing indices of each (k,) subset apart, deterministically:
    column ``col`` moves to ``(idx + prev + 1) % n`` where it equals
    column ``prev`` (the JAX package's ``_sample_distinct`` after its
    ``randint`` draw; the reference re-rolls, segmentation.rs:46-96).  A
    pair always ends distinct; a triple can keep a repeat, as there."""
    idx = idx.clone()
    for col in range(1, idx.shape[1]):
        for prev in range(col):
            clash = idx[:, col] == idx[:, prev]
            idx[:, col] = torch.where(clash, (idx[:, col] + prev + 1) % n,
                                      idx[:, col])
    return idx


def _sample_indices(seed: int, iters: int, n: int, k: int) -> torch.Tensor:
    """(iters, k) int64 subset indices in ``[0, n)`` on the CPU: a
    ``torch.Generator`` draw seeded by ``seed``, then :func:`_decollide`."""
    gen = torch.Generator().manual_seed(int(seed))
    return _decollide(torch.randint(0, n, (iters, k), generator=gen), n)


def _hypothesis_distances(pos: torch.Tensor, samples: torch.Tensor,
                          k: int) -> torch.Tensor:
    """(c, P) distances of ``pos`` (P, 3) to the c hypotheses ``samples``
    (c, k, 3), by the JAX package's formulas: ``|p·n + d| / |n|`` for a
    plane, ``|dvec × (s0 - p)| / |dvec|`` for a line.  Hypotheses run
    down the rows, so that counts reduce along contiguous memory."""
    s0 = samples[:, 0]
    if k == 3:
        normal = torch.linalg.cross(samples[:, 1] - s0, samples[:, 2] - s0)
        dcoef = -(normal * s0).sum(dim=1, keepdim=True)
        nrm = torch.linalg.vector_norm(normal, dim=1, keepdim=True)
        return (normal @ pos.T).add_(dcoef).abs_().div_(nrm.clamp_min(1e-30))
    dvec = samples[:, 1] - s0
    rel = s0[:, None] - pos[None]                       # (c, P, 3)
    cr = torch.linalg.cross(dvec[:, None].expand_as(rel), rel)
    return torch.linalg.vector_norm(cr, dim=-1).div_(
        torch.linalg.vector_norm(dvec, dim=-1, keepdim=True).clamp_min(1e-30))


def _score_hypotheses(pos: torch.Tensor, mask: torch.Tensor,
                      samples: torch.Tensor, k: int,
                      threshold: float) -> torch.Tensor:
    """(H,) int64 inlier counts: points with distance < ``threshold`` and
    ``mask`` set, for each of the H hypotheses ``samples`` (H, k, 3), in
    blocks of ``_POINT_CHUNK[k]`` points × ``_HYPO_CHUNK`` hypotheses."""
    rows = _POINT_CHUNK[k]
    counts = torch.zeros(samples.shape[0], dtype=torch.int64,
                         device=pos.device)
    for h in range(0, samples.shape[0], _HYPO_CHUNK):
        chunk = samples[h:h + _HYPO_CHUNK]
        for p in range(0, pos.shape[0], rows):
            dist = _hypothesis_distances(pos[p:p + rows], chunk, k)
            inlier = (dist < threshold) & mask[None, p:p + rows]
            counts[h:h + chunk.shape[0]] += inlier.sum(dim=1)
    return counts


def _ransac_from_samples(pos: torch.Tensor, mask: torch.Tensor,
                         samples: torch.Tensor, k: int, threshold: float
                         ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """Winner among the hypotheses ``samples``: (its (k, 3) sample, its
    count, its inlier mask recomputed over all points).  The first maximum
    wins, as ``argmax`` does in the JAX package."""
    counts = _score_hypotheses(pos, mask, samples, k, threshold)
    best = int(torch.argmax(counts).item())
    best_sample = samples[best]
    dist = _hypothesis_distances(pos, best_sample[None], k)[0]
    return best_sample, int(counts[best].item()), (dist < threshold) & mask


def _ransac_device(buffer, device, k: int, distance_threshold: float,
                   num_of_iterations: int, seed: int):
    """Positions and mask where the batch lives (a host buffer goes to
    ``device`` as float32), ``iters`` rounded up to a multiple of
    ``_HYPO_CHUNK`` — the extra hypotheses can win — and indices drawn from
    the first ``max(valid, k)`` rows, as in the JAX package."""
    if isinstance(buffer, PointBatch):
        pos = buffer.data[att.POSITION_3D.name]
        mask = buffer.valid_mask()
        n = int(buffer.count.item())
    else:
        dev = resolve_device(device)
        pos = torch.from_numpy(np.ascontiguousarray(
            buffer.get_converted(att.POSITION_3D), dtype=np.float32)).to(dev)
        n = len(buffer)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    nvalid = max(n, k)
    iters = -(-num_of_iterations // _HYPO_CHUNK) * _HYPO_CHUNK
    idx = _sample_indices(seed, iters, nvalid, k).to(pos.device)
    with fp32_matmul():
        sample, count, inlier = _ransac_from_samples(
            pos, mask, pos[idx], k, distance_threshold)
    return (sample.cpu().numpy().astype(np.float64), count,
            np.flatnonzero(inlier.cpu().numpy()))


def ransac_plane_device(batch: Union[PointBatch, HostPointBuffer],
                        distance_threshold: float, num_of_iterations: int,
                        seed: int = 0,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Tuple[Plane, np.ndarray]:
    """Device RANSAC plane; returns (Plane, inlier indices).  A
    :class:`PointBatch` is scored where it lives; a host buffer goes to
    ``device`` (``None``: the GPU, raising without one).  The plane is
    rebuilt from the winning samples in f64 on the host."""
    s, count, inliers = _ransac_device(batch, device, 3, distance_threshold,
                                       num_of_iterations, seed)
    normal = np.cross(s[1] - s[0], s[2] - s[0])
    plane = Plane(normal[0], normal[1], normal[2], -normal @ s[0], count)
    return plane, inliers


def ransac_line_device(batch: Union[PointBatch, HostPointBuffer],
                       distance_threshold: float, num_of_iterations: int,
                       seed: int = 0,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Tuple[Line, np.ndarray]:
    """Device RANSAC line fit; returns (Line, inlier indices).  Where the
    batch is scored as in :func:`ransac_plane_device`; the line is built
    from the winning samples in f64 on the host."""
    s, count, inliers = _ransac_device(batch, device, 2, distance_threshold,
                                       num_of_iterations, seed)
    return Line(s[0], s[1], count), inliers
