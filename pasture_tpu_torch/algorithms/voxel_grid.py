"""Voxel-grid downsampling — host-exact parity path + device path.

``voxelgrid_filter`` reproduces pasture's algorithm bit-for-bit on host
(reference: pasture-algorithms/src/voxel_grid.rs:109-165): markers built by
*accumulated* addition (so the same floating-point drift), nearest-marker
cell assignment (voxel_grid.rs:22-51), voxels emitted in ascending
(x, y, z) tuple order, per-attribute centroid reductions in f64
(voxel_grid.rs:443-700).  For device batches it dispatches to
:func:`pasture_tpu_torch.ops.voxel_downsample` (Morton-sorted segmented
reductions, voxel order = Morton order).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from ..buffers.device import PointBatch
from ..buffers.host import HostPointBuffer
from ..layout import attributes as att
from ..ops.voxel import DEFAULT_POLICIES, _WAVEFORM_NAMES, voxel_downsample

__all__ = ["voxelgrid_filter"]


def _markers(lo: float, hi: float, leaf: float) -> np.ndarray:
    """Accumulated markers, identical to create_markers_for_axis
    (voxel_grid.rs:54-79)."""
    out = []
    curr = lo
    while curr < hi:
        curr += leaf
        out.append(curr)
    return np.asarray(out, np.float64)


def _find_leaf_axis(p: np.ndarray, markers: np.ndarray) -> np.ndarray:
    """Vectorised find_leaf for one axis (voxel_grid.rs:22-51): first marker
    >= p, then clamp to the nearer of markers[i-1] / markers[i]."""
    if len(markers) == 0:
        return np.zeros(len(p), np.int64)
    idx = np.searchsorted(markers, p, side="left")
    idx = np.minimum(idx, len(markers) - 1)
    prev_ok = idx > 0
    prev = markers[np.maximum(idx - 1, 0)]
    nxt = markers[idx]
    closer_prev = prev_ok & ((p - prev) < (nxt - p))
    return np.where(closer_prev, idx - 1, idx)


def voxelgrid_filter(buffer: Union[HostPointBuffer, PointBatch],
                     leafsize_x: float, leafsize_y: float = None,
                     leafsize_z: float = None,
                     policies: Optional[Dict[str, str]] = None
                     ) -> Union[HostPointBuffer, PointBatch]:
    """Downsample by voxel-grid centroids (reference voxelgrid_filter).

    Host buffers use the exact reference semantics; device batches use the
    Morton/segmented device path (leaf must then be cubic).
    """
    if leafsize_y is None:
        leafsize_y = leafsize_x
    if leafsize_z is None:
        leafsize_z = leafsize_x

    if isinstance(buffer, PointBatch):
        if not (leafsize_x == leafsize_y == leafsize_z):
            raise ValueError("device path supports cubic leaves only")
        return voxel_downsample(buffer, leafsize_x, policies=policies)

    if not buffer.schema.has_attribute_with_name(att.POSITION_3D.name):
        raise ValueError(
            "buffer has no Position3D attribute, needed for the voxel grid")
    for name in buffer.schema.names:
        if name in _WAVEFORM_NAMES:
            raise ValueError("waveform data currently not supported "
                             "(voxel_grid.rs:452-459 parity)")

    pos = buffer.get_converted(att.POSITION_3D)
    n = len(buffer)
    if n == 0:
        return buffer.slice(0, 0)

    mn, mx = pos.min(axis=0), pos.max(axis=0)
    mx_ = [_markers(mn[a], mx[a], [leafsize_x, leafsize_y, leafsize_z][a])
           for a in range(3)]
    cells = np.stack([_find_leaf_axis(pos[:, a], mx_[a]) for a in range(3)],
                     axis=1)

    # group points by cell, voxels ordered by (x, y, z) tuple like the
    # reference's sorted Vec (voxel_grid.rs:130-153)
    order = np.lexsort((cells[:, 2], cells[:, 1], cells[:, 0]))
    sc = cells[order]
    new_seg = np.ones(n, bool)
    new_seg[1:] = np.any(sc[1:] != sc[:-1], axis=1)
    seg_id = np.cumsum(new_seg) - 1
    n_vox = int(seg_id[-1]) + 1

    pol = dict(DEFAULT_POLICIES)
    if policies:
        pol.update(policies)

    out_cols: Dict[str, np.ndarray] = {}
    starts = np.flatnonzero(new_seg)
    ends = np.append(starts[1:], n)
    for m in buffer.schema.members:
        col = buffer.columns[m.name][order]
        p = pol.get(m.name)
        if p is None:
            p = "mean" if m.dtype.kind == "float" else "mode"
        out = np.zeros((n_vox,) + m.dtype.np_shape, m.dtype.np_component_dtype)
        if p == "mean":
            sums = np.add.reduceat(col.astype(np.float64), starts, axis=0)
            cnt = (ends - starts).astype(np.float64)
            mean = sums / cnt.reshape((-1,) + (1,) * (col.ndim - 1))
            out = _rust_as_from_f64(mean, m.dtype.np_component_dtype)
        elif p == "max":
            mxv = np.maximum.reduceat(col.astype(np.float64), starts, axis=0)
            # reference max_pool starts at 0.0 (voxel_grid.rs:168-216)
            out = _rust_as_from_f64(np.maximum(mxv, 0.0),
                                    m.dtype.np_component_dtype)
        elif p == "mode":
            # vectorised per-segment mode: sort (segment, value), run-length
            # encode, then rank runs by (segment, -length, value) — first
            # run per segment is the mode with smallest-value tie-break
            out = np.zeros(n_vox, m.dtype.np_component_dtype)
            o2 = np.lexsort((col, seg_id))
            sv, ss = col[o2], seg_id[o2]
            run_new = np.ones(n, bool)
            run_new[1:] = (ss[1:] != ss[:-1]) | (sv[1:] != sv[:-1])
            run_starts = np.flatnonzero(run_new)
            run_len = np.diff(np.append(run_starts, n))
            run_seg, run_val = ss[run_starts], sv[run_starts]
            o3 = np.lexsort((run_val, -run_len, run_seg))
            seg_sorted = run_seg[o3]
            firsts = np.ones(len(o3), bool)
            firsts[1:] = seg_sorted[1:] != seg_sorted[:-1]
            out[seg_sorted[firsts]] = run_val[o3][firsts]
        else:
            raise ValueError(f"unknown policy {p!r} for {m.name!r}")
        out_cols[m.name] = np.ascontiguousarray(
            out, m.dtype.np_component_dtype)
    return HostPointBuffer(buffer.schema, out_cols, validate=False)


def _rust_as_from_f64(x: np.ndarray, dst: np.dtype) -> np.ndarray:
    from ..layout.conversion import rust_as_cast
    return rust_as_cast(x, dst)
