"""3D convex hull (parity: pasture-algorithms/src/convexhull.rs:41-460).

Port of pasture_tpu/algorithms/convexhull.py (a host algorithm: a device
batch's valid positions come to the host as f64).  Incremental insertion hull with the same public contract as the reference:
``convex_hull_as_triangle_mesh`` returns index triangles (error for fewer
than 3 linearly independent points), ``convex_hull_as_points`` returns the
unique hull vertex indices and also handles the degenerate point/segment/
polygon cases.  Implementation is vectorised numpy on host: per inserted
point the face visibility test is one matrix product over all current faces
(the reference iterates faces one by one, convexhull.rs:84-397).

Degenerate inputs: collinear clouds yield the two extreme endpoints
(as_points) / an error (as_triangle_mesh); coplanar clouds yield the 2D hull
polygon triangulated as a fan.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np

from ..buffers.device import PointBatch
from ..buffers.host import HostPointBuffer
from ..layout import attributes as att

__all__ = ["convex_hull_as_triangle_mesh", "convex_hull_as_points"]

_EPS = 1e-10


def _positions(buffer) -> np.ndarray:
    if isinstance(buffer, PointBatch):
        n = int(buffer.count.item())
        return buffer.data[att.POSITION_3D.name][:n].cpu().numpy().astype(
            np.float64)
    if not buffer.schema.has_attribute_with_name(att.POSITION_3D.name):
        raise ValueError("point buffer contains no position attribute")
    return buffer.get_converted(att.POSITION_3D)


def _hull_2d(points2: np.ndarray) -> np.ndarray:
    """Monotone-chain 2D hull; returns CCW vertex indices."""
    order = np.lexsort((points2[:, 1], points2[:, 0]))

    def half(indices):
        chain: List[int] = []
        for i in indices:
            while len(chain) >= 2:
                o, a = points2[chain[-2]], points2[chain[-1]]
                cross = (a[0] - o[0]) * (points2[i][1] - o[1]) - \
                        (a[1] - o[1]) * (points2[i][0] - o[0])
                if cross <= _EPS:
                    chain.pop()
                else:
                    break
            chain.append(i)
        return chain[:-1]

    lower = half(order)
    upper = half(order[::-1])
    return np.asarray(lower + upper, dtype=np.int64)


def _initial_simplex(pos: np.ndarray):
    """Find 4 affinely independent points, or report the degeneracy rank."""
    n = len(pos)
    i0 = 0
    i1 = next((i for i in range(n) if not np.allclose(pos[i], pos[i0])), None)
    if i1 is None:
        return ("point", [i0])
    d = pos[i1] - pos[i0]
    cross = np.cross(np.broadcast_to(d, pos.shape), pos - pos[i0])
    nrm = np.linalg.norm(cross, axis=1)
    i2 = int(np.argmax(nrm))
    if nrm[i2] <= _EPS * max(1.0, np.abs(pos).max()) ** 2:
        # collinear: the two extreme points along d
        t = (pos - pos[i0]) @ d
        return ("segment", [int(np.argmin(t)), int(np.argmax(t))])
    normal = np.cross(d, pos[i2] - pos[i0])
    h = (pos - pos[i0]) @ normal
    i3 = int(np.argmax(np.abs(h)))
    if abs(h[i3]) <= _EPS * max(1.0, np.abs(pos).max()) ** 3:
        return ("planar", [i0, i1, i2], normal)
    return ("full", [i0, i1, i2, i3])


def _incremental_hull(pos: np.ndarray, simplex) -> np.ndarray:
    """3D incremental hull; returns (F, 3) index triangles with outward
    normals."""
    i0, i1, i2, i3 = simplex
    faces = [(i0, i1, i2), (i0, i1, i3), (i0, i2, i3), (i1, i2, i3)]
    centroid = pos[simplex].mean(axis=0)

    def orient(f):
        a, b, c = f
        nrm = np.cross(pos[b] - pos[a], pos[c] - pos[a])
        if nrm @ (centroid - pos[a]) > 0:
            return (a, c, b)
        return f

    faces = [orient(f) for f in faces]
    face_arr = np.asarray(faces, np.int64)
    normals = np.cross(pos[face_arr[:, 1]] - pos[face_arr[:, 0]],
                       pos[face_arr[:, 2]] - pos[face_arr[:, 0]])
    offsets = np.einsum("ij,ij->i", normals, pos[face_arr[:, 0]])

    scale = max(1.0, float(np.abs(pos).max())) ** 2
    in_simplex = set(simplex)
    for p in range(len(pos)):
        if p in in_simplex:
            continue
        vis = pos[p] @ normals.T - offsets > _EPS * scale
        if not vis.any():
            continue
        visible = face_arr[vis]
        # horizon = edges of visible faces shared with exactly one visible face
        edges = {}
        for a, b, c in visible:
            for e in ((a, b), (b, c), (c, a)):
                k = (min(e), max(e))
                if k in edges:
                    edges.pop(k)          # interior edge, seen twice
                else:
                    edges[k] = e          # keep directed edge
        keep = ~vis
        new_faces = [(e[0], e[1], p) for e in edges.values()]
        face_arr = np.concatenate([face_arr[keep],
                                   np.asarray(new_faces, np.int64)])
        new_n = np.cross(pos[face_arr[-len(new_faces):, 1]]
                         - pos[face_arr[-len(new_faces):, 0]],
                         pos[face_arr[-len(new_faces):, 2]]
                         - pos[face_arr[-len(new_faces):, 0]])
        normals = np.concatenate([normals[keep], new_n])
        offsets = np.concatenate([
            offsets[keep],
            np.einsum("ij,ij->i", new_n,
                      pos[face_arr[-len(new_faces):, 0]])])
    return face_arr


def convex_hull_as_triangle_mesh(buffer: Union[HostPointBuffer, PointBatch]
                                 ) -> np.ndarray:
    """(F, 3) triangle index array (reference convexhull.rs:41-54).  Raises
    ``ValueError`` for fewer than 3 linearly independent points."""
    pos = _positions(buffer)
    if len(pos) == 0:
        raise ValueError("input buffer contains too few linearly "
                         "independent points")
    kind = _initial_simplex(pos)
    if kind[0] in ("point", "segment"):
        raise ValueError("input buffer contains too few linearly "
                         "independent points")
    if kind[0] == "planar":
        normal = kind[2]
        # project to the dominant plane and 2D-hull
        ax = int(np.argmax(np.abs(normal)))
        cols = [c for c in range(3) if c != ax]
        hull = _hull_2d(pos[:, cols])
        if len(hull) < 3:
            raise ValueError("input buffer contains too few linearly "
                             "independent points")
        return np.stack([np.full(len(hull) - 2, hull[0]),
                         hull[1:-1], hull[2:]], axis=1)
    return _incremental_hull(pos, kind[1])


def convex_hull_as_points(buffer: Union[HostPointBuffer, PointBatch]
                          ) -> np.ndarray:
    """Unsorted unique hull vertex indices (reference convexhull.rs:63-82);
    degenerate clouds yield the point / the two segment endpoints."""
    pos = _positions(buffer)
    if len(pos) == 0:
        return np.zeros(0, np.int64)
    kind = _initial_simplex(pos)
    if kind[0] == "point":
        return np.asarray(kind[1], np.int64)
    if kind[0] == "segment":
        return np.unique(np.asarray(kind[1], np.int64))
    if kind[0] == "planar":
        ax = int(np.argmax(np.abs(kind[2])))
        cols = [c for c in range(3) if c != ax]
        return np.unique(_hull_2d(pos[:, cols]))
    return np.unique(_incremental_hull(pos, kind[1]).ravel())
