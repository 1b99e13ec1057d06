"""Test utilities: random point distributions and scenario clouds.

Parity with the reference's test_utils (pasture-core/src/test_utils.rs:1-55
``DefaultPointDistribution``): deterministic random clouds over a schema,
used by the framework's own tests and available to downstream users.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .buffers.host import HostPointBuffer
from .layout import attributes as att
from .layout.schema import PointSchema

__all__ = ["random_point_buffer", "DEFAULT_TEST_SCHEMA"]

DEFAULT_TEST_SCHEMA = PointSchema.from_attributes([
    att.POSITION_3D, att.INTENSITY, att.RETURN_NUMBER,
    att.NUMBER_OF_RETURNS, att.CLASSIFICATION, att.SCAN_ANGLE_RANK,
    att.USER_DATA, att.POINT_SOURCE_ID, att.GPS_TIME, att.COLOR_RGB,
])


def random_point_buffer(n: int, schema: Optional[PointSchema] = None,
                        seed: int = 0,
                        position_range: float = 100.0) -> HostPointBuffer:
    """Uniformly random points for every attribute of ``schema``
    (the ``DefaultPointDistribution`` analog, deterministic per seed)."""
    schema = schema or DEFAULT_TEST_SCHEMA
    rng = np.random.default_rng(seed)
    cols = {}
    for m in schema.members:
        dt = m.dtype
        shape = (n,) + dt.np_shape
        if dt.kind == "float":
            if m.name == att.POSITION_3D.name:
                cols[m.name] = rng.uniform(-position_range, position_range,
                                           shape)
            else:
                cols[m.name] = rng.uniform(0, 1000, shape)
        elif dt.kind in ("uint", "int"):
            info = np.iinfo(dt.np_component_dtype)
            lo = max(info.min, -(2 ** 31))
            hi = min(info.max, 2 ** 31 - 1)
            cols[m.name] = rng.integers(lo, hi, shape, endpoint=True)
        else:
            cols[m.name] = rng.integers(0, 256, shape)
    return HostPointBuffer.from_columns(schema, cols)
