"""Attribute min/max (parity: pasture-algorithms/src/minmax.rs:13-52)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ..buffers.device import PointBatch
from ..buffers.host import HostPointBuffer
from ..layout.attributes import PointAttribute
from ..math.minmax import minmax_column
from ..ops.reductions import masked_minmax

__all__ = ["minmax_attribute"]


def minmax_attribute(buffer: Union[HostPointBuffer, PointBatch],
                     attribute: Union[str, PointAttribute]
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(min, max) of an attribute, componentwise for vectors, NaN-ignoring
    for floats; ``None`` for empty input.  Host buffers convert to the
    requested dtype first (reference's conversion fallback).  A device
    batch answers in the column's logical dtype; its emptiness test reads
    ``count`` to the host."""
    if isinstance(buffer, PointBatch):
        name = attribute if isinstance(attribute, str) else attribute.name
        if name not in buffer.data:
            raise KeyError(f"attribute {name!r} not in batch")
        if int(buffer.count.item()) == 0:
            return None
        mn, mx = masked_minmax(buffer.data[name], buffer.valid_mask())
        logical = buffer.logical_dtype(name)
        return (mn.cpu().numpy().astype(logical),
                mx.cpu().numpy().astype(logical))
    if len(buffer) == 0:
        return None
    if isinstance(attribute, PointAttribute) and \
            buffer.schema.member(attribute.name).dtype != attribute.dtype:
        col = buffer.get_converted(attribute)
    else:
        col = buffer.get(attribute)
    return minmax_column(col)
