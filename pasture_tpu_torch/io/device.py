"""File -> device batch, preserving exact position semantics.

``read_batch`` is the precision-aware ingest path: for LAS/LAZ sources the
positions stay as the file's native i32 local coordinates plus the f64
scale/offset carried in ``batch.meta`` — nothing is rounded through f32
world space.  ``batch_positions`` decodes them on the device (anchored f32
by default: exact for realistic tile extents).  Non-LAS sources fall back
to casting f64 world positions under the device policy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..buffers.device import PointBatch
from ..layout import attributes as att
from ..layout.dtypes import DevicePolicy
from ..ops.transform import decode_las_positions
from .base import open_reader
from .las import ATTRIBUTE_LOCAL_LAS_POSITION, LasReader

__all__ = ["read_batch", "batch_positions"]

META_SCALE = "las_scale"
META_OFFSET = "las_offset"
META_ANCHOR = "las_anchor"


def read_batch(path: Union[str, Path],
               policy: DevicePolicy = DevicePolicy.NARROW,
               capacity: Optional[int] = None,
               exact_positions: bool = True,
               device: Optional[Union[str, torch.device]] = None
               ) -> PointBatch:
    """Read a point-cloud file straight into a device batch
    (``device=None`` means the GPU and raises without one).

    For LAS/LAZ with ``exact_positions`` the batch carries
    ``LASLocalPosition`` (i32) + ``las_scale`` / ``las_offset`` (f64) /
    ``las_anchor`` (i32, the locals' minimum) meta instead of a lossy f32
    ``Position3D``; decode positions with :func:`batch_positions`.
    """
    dev = resolve_device(device)
    suffix = Path(path).suffix.lower()
    if exact_positions and suffix in (".las", ".laz"):
        with LasReader(path, point_schema_matches_memory_layout=True) as r:
            wire = r.read_all()
            header = r.header
        batch = PointBatch.from_host(wire, policy=policy, capacity=capacity,
                                     device=dev)
        local = wire.get(ATTRIBUTE_LOCAL_LAS_POSITION.name)
        anchor = (local.min(axis=0).astype(np.int32) if len(wire)
                  else np.zeros(3, np.int32))
        return (batch
                .with_meta(META_SCALE, torch.from_numpy(
                    np.array(header.scale_np, np.float64)).to(dev))
                .with_meta(META_OFFSET, torch.from_numpy(
                    np.array(header.offset_np, np.float64)).to(dev))
                .with_meta(META_ANCHOR, torch.from_numpy(anchor).to(dev)))
    with open_reader(path) as r:
        host = r.read_all()
    return PointBatch.from_host(host, policy=policy, capacity=capacity,
                                device=dev)


def batch_positions(batch: PointBatch, anchored: bool = True,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """World positions (N, 3) of a batch on its device.

    Exact-ingest batches decode i32 local coords against the stored scale;
    with ``anchored`` the result is relative to the batch anchor (f32-exact;
    absolute world = result + anchor*scale + offset, both in meta).
    Otherwise the ``Position3D`` column is returned in ``dtype``.
    """
    if ATTRIBUTE_LOCAL_LAS_POSITION.name in batch.data:
        local = batch.data[ATTRIBUTE_LOCAL_LAS_POSITION.name]
        scale = batch.meta[META_SCALE]
        offset = batch.meta[META_OFFSET]
        anchor = batch.meta[META_ANCHOR] if anchored else None
        return decode_las_positions(local, scale, offset, anchor=anchor,
                                    dtype=dtype)
    return batch.data[att.POSITION_3D.name].to(dtype)
