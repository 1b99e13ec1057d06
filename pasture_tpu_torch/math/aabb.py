"""Axis-aligned bounding boxes.

Parity with pasture's ``AABB<T>`` (reference:
pasture-core/src/math/bounds.rs:9-316), as a plain frozen dataclass over
numpy vectors (host math is f64-exact; device bounds are computed by
pasture_tpu_torch ops/reductions.py and wrapped into this type afterwards).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

__all__ = ["AABB"]


def _vec3(v) -> np.ndarray:
    a = np.asarray(v, dtype=np.float64).reshape(3)
    return a


@dataclasses.dataclass(frozen=True)
class AABB:
    """3D axis-aligned bounding box with inclusive min/max corners."""

    min: np.ndarray
    max: np.ndarray

    # ---- constructors (bounds.rs:24-80) ---------------------------------------
    @staticmethod
    def from_min_max(mn, mx) -> "AABB":
        mn, mx = _vec3(mn), _vec3(mx)
        if np.any(mn > mx):
            raise ValueError(f"AABB min {mn} must be <= max {mx}")
        return AABB(mn, mx)

    @staticmethod
    def from_min_max_unchecked(mn, mx) -> "AABB":
        return AABB(_vec3(mn), _vec3(mx))

    @staticmethod
    def from_points(points: Iterable) -> Optional["AABB"]:
        """Build from an iterable/array of points (``FromIterator`` parity,
        bounds.rs:270-316).  Returns None for an empty input."""
        pts = np.asarray(list(points) if not isinstance(points, np.ndarray) else points,
                         dtype=np.float64)
        if pts.size == 0:
            return None
        pts = pts.reshape(-1, 3)
        return AABB(pts.min(axis=0), pts.max(axis=0))

    # ---- queries (bounds.rs:82-250) -------------------------------------------
    @property
    def extent(self) -> np.ndarray:
        return self.max - self.min

    @property
    def center(self) -> np.ndarray:
        return (self.min + self.max) * 0.5

    def intersects(self, other: "AABB") -> bool:
        return bool(np.all(self.min <= other.max) and np.all(other.min <= self.max))

    def contains(self, point) -> bool:
        p = _vec3(point)
        return bool(np.all(p >= self.min) and np.all(p <= self.max))

    def contains_approx(self, point, epsilon: float = 1e-5) -> bool:
        p = _vec3(point)
        return bool(np.all(p >= self.min - epsilon) and np.all(p <= self.max + epsilon))

    def union(self, other: "AABB") -> "AABB":
        return AABB(np.minimum(self.min, other.min), np.maximum(self.max, other.max))

    def extend_with_point(self, point) -> "AABB":
        p = _vec3(point)
        return AABB(np.minimum(self.min, p), np.maximum(self.max, p))

    def as_cubic(self) -> "AABB":
        """Smallest cube with the same center containing this box
        (bounds.rs ``as_cubic``)."""
        half = float(self.extent.max()) * 0.5
        c = self.center
        return AABB(c - half, c + half)

    # ---- equality -------------------------------------------------------------
    def __eq__(self, other) -> bool:
        if not isinstance(other, AABB):
            return NotImplemented
        return bool(np.array_equal(self.min, other.min)
                    and np.array_equal(self.max, other.max))

    def __hash__(self):
        return hash((self.min.tobytes(), self.max.tobytes()))

    def __repr__(self) -> str:
        return f"AABB(min={self.min.tolist()}, max={self.max.tolist()})"
