"""Bounding-box computation (parity: pasture-algorithms/src/bounds.rs:12-100).

``calculate_bounds`` accepts a host buffer (exact f64 math, like the
reference) or a device batch (masked reduction on device, see
pasture_tpu_torch/ops/reductions.py ``batch_bounds``).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ..buffers.device import PointBatch
from ..buffers.host import HostPointBuffer
from ..layout import attributes as att
from ..math.aabb import AABB
from ..ops.reductions import batch_bounds

__all__ = ["calculate_bounds"]


def calculate_bounds(buffer: Union[HostPointBuffer, PointBatch]
                     ) -> Optional[AABB]:
    """AABB of POSITION_3D; ``None`` for an empty cloud.

    The reference has a fast path for the default Vec3f64 dtype and a
    converting path otherwise (bounds.rs:12-100); here the column is used
    as-is and converted to f64 for the AABB corners.  For a device batch
    the emptiness test reads ``count`` to the host."""
    name = att.POSITION_3D.name
    if isinstance(buffer, PointBatch):
        if name not in buffer.data:
            raise ValueError("buffer has no Position3D attribute")
        if int(buffer.count.item()) == 0:
            return None
        mn, mx = batch_bounds(buffer.data[name], buffer.valid_mask())
        return AABB.from_min_max_unchecked(
            mn.cpu().numpy().astype(np.float64),
            mx.cpu().numpy().astype(np.float64))
    if not buffer.schema.has_attribute_with_name(name):
        raise ValueError("buffer has no Position3D attribute")
    if len(buffer) == 0:
        return None
    # fast path for the default Vec3f64 dtype (reference bounds.rs:12-100
    # has the same split); converting path otherwise
    if buffer.schema.member(name).dtype == att.POSITION_3D.dtype:
        pos = buffer.get(name)
    else:
        pos = buffer.get_converted(att.POSITION_3D)
    return AABB.from_min_max_unchecked(pos.min(axis=0), pos.max(axis=0))
