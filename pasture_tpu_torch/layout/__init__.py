"""Point schema / attribute / dtype system (pasture-core ``layout`` parity).

Reference: pasture-core/src/layout/ — a columnar, device-first data model;
the wire (interleaved) layout survives only as host I/O metadata.  numpy
only: nothing here touches the device.
"""

from . import attributes, dtypes
from .attributes import PointAttribute
from .conversion import SchemaConverter, convert_attribute_column, rust_as_cast
from .dtypes import DevicePolicy, PointDtype, byte_array, custom, dtype_from_name
from .schema import FieldAlignment, PointSchema, SchemaMember, align_to

__all__ = [
    "attributes", "dtypes",
    "PointAttribute", "PointDtype", "PointSchema", "SchemaMember",
    "FieldAlignment", "DevicePolicy", "SchemaConverter",
    "convert_attribute_column", "rust_as_cast",
    "byte_array", "custom", "dtype_from_name", "align_to",
]
