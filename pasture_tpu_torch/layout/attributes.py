"""Point attribute definitions and the canonical builtin attributes.

Mirrors the semantic contract of pasture's ``PointAttributeDefinition`` and
its ``attributes`` module (reference:
pasture-core/src/layout/point_layout.rs:261-443 and :454-598).  Attribute
identity is the *name*; the dtype is the default wire/type representation and
may be converted (see pasture_tpu_torch.layout.conversion).
"""

from __future__ import annotations

import dataclasses

from . import dtypes as dt
from .dtypes import PointDtype

__all__ = [
    "PointAttribute",
    # builtins (pasture-core point_layout.rs:454-598)
    "POSITION_3D", "INTENSITY", "RETURN_NUMBER", "NUMBER_OF_RETURNS",
    "CLASSIFICATION_FLAGS", "SCANNER_CHANNEL", "SCAN_DIRECTION_FLAG",
    "EDGE_OF_FLIGHT_LINE", "CLASSIFICATION", "SCAN_ANGLE_RANK", "SCAN_ANGLE",
    "USER_DATA", "POINT_SOURCE_ID", "COLOR_RGB", "COLOR_RGBA", "GPS_TIME",
    "NIR", "WAVE_PACKET_DESCRIPTOR_INDEX", "WAVEFORM_DATA_OFFSET",
    "WAVEFORM_PACKET_SIZE", "RETURN_POINT_WAVEFORM_LOCATION",
    "WAVEFORM_PARAMETERS", "POINT_ID", "NORMAL",
    "BUILTIN_ATTRIBUTES",
]


@dataclasses.dataclass(frozen=True)
class PointAttribute:
    """An attribute = (name, datatype).

    Equality/hashing uses both fields, like the reference.  Use
    :meth:`with_dtype` to re-type an attribute (reference
    ``with_custom_datatype``, point_layout.rs:335).
    """

    name: str
    dtype: PointDtype

    def with_dtype(self, dtype: PointDtype) -> "PointAttribute":
        return PointAttribute(self.name, dtype)

    @property
    def size(self) -> int:
        return self.dtype.size

    def __str__(self) -> str:
        return f"{self.name};{self.dtype}"


# --- canonical builtins; names must match pasture exactly (bit-exact I/O parity)
POSITION_3D = PointAttribute("Position3D", dt.VEC3F64)
INTENSITY = PointAttribute("Intensity", dt.U16)
RETURN_NUMBER = PointAttribute("ReturnNumber", dt.U8)
NUMBER_OF_RETURNS = PointAttribute("NumberOfReturns", dt.U8)
CLASSIFICATION_FLAGS = PointAttribute("ClassificationFlags", dt.U8)
SCANNER_CHANNEL = PointAttribute("ScannerChannel", dt.U8)
SCAN_DIRECTION_FLAG = PointAttribute("ScanDirectionFlag", dt.U8)
EDGE_OF_FLIGHT_LINE = PointAttribute("EdgeOfFlightLine", dt.U8)
CLASSIFICATION = PointAttribute("Classification", dt.U8)
SCAN_ANGLE_RANK = PointAttribute("ScanAngleRank", dt.I8)
SCAN_ANGLE = PointAttribute("ScanAngle", dt.I16)
USER_DATA = PointAttribute("UserData", dt.U8)
POINT_SOURCE_ID = PointAttribute("PointSourceID", dt.U16)
COLOR_RGB = PointAttribute("ColorRGB", dt.VEC3U16)
#: 4-channel color as used by 3D Tiles (reference: pasture-io tiles3d/pnts_types.rs:11)
COLOR_RGBA = PointAttribute("ColorRGBA", dt.VEC4U8)
GPS_TIME = PointAttribute("GpsTime", dt.F64)
NIR = PointAttribute("NIR", dt.U16)
WAVE_PACKET_DESCRIPTOR_INDEX = PointAttribute("WavePacketDescriptorIndex", dt.U8)
WAVEFORM_DATA_OFFSET = PointAttribute("WaveformDataOffset", dt.U64)
WAVEFORM_PACKET_SIZE = PointAttribute("WaveformPacketSize", dt.U32)
RETURN_POINT_WAVEFORM_LOCATION = PointAttribute("ReturnPointWaveformLocation", dt.F32)
WAVEFORM_PARAMETERS = PointAttribute("WaveformParameters", dt.VEC3F32)
POINT_ID = PointAttribute("PointID", dt.U64)
NORMAL = PointAttribute("Normal", dt.VEC3F32)

BUILTIN_ATTRIBUTES = (
    POSITION_3D, INTENSITY, RETURN_NUMBER, NUMBER_OF_RETURNS,
    CLASSIFICATION_FLAGS, SCANNER_CHANNEL, SCAN_DIRECTION_FLAG,
    EDGE_OF_FLIGHT_LINE, CLASSIFICATION, SCAN_ANGLE_RANK, SCAN_ANGLE,
    USER_DATA, POINT_SOURCE_ID, COLOR_RGB, COLOR_RGBA, GPS_TIME, NIR,
    WAVE_PACKET_DESCRIPTOR_INDEX, WAVEFORM_DATA_OFFSET, WAVEFORM_PACKET_SIZE,
    RETURN_POINT_WAVEFORM_LOCATION, WAVEFORM_PARAMETERS, POINT_ID, NORMAL,
)
