"""LAS point-format <-> PointSchema mapping.

Parity with pasture's las_layout (reference:
pasture-io/src/las/las_layout.rs) and the derive-generated default point
types (las_types.rs:14-625):

* the **exact binary** schema mirrors the wire record: ``LASLocalPosition``
  (Vec3i32), packed ``LASBasicFlags`` (U8) / ``LASExtendedFlags`` (U16),
  packed(1) placement — sizes 20/28/26/34/57/63/30/36/38/59/67;
* the **default** schema has world-space Vec3f64 positions and unpacked
  flag attributes, field order matching ``LasPointFormatN``.
"""

from __future__ import annotations

from typing import List, Optional

from ...layout import attributes as att
from ...layout import dtypes as dt
from ...layout.attributes import PointAttribute
from ...layout.schema import PointSchema
from .header import LasPointFormat

__all__ = [
    "ATTRIBUTE_BASIC_FLAGS", "ATTRIBUTE_EXTENDED_FLAGS",
    "ATTRIBUTE_LOCAL_LAS_POSITION",
    "point_schema_from_las_format", "las_format_from_point_schema",
    "is_known_las_attribute", "KNOWN_LAS_ATTRIBUTE_NAMES",
]

#: custom attributes used by the exact binary schema (las_layout.rs:37-49)
ATTRIBUTE_BASIC_FLAGS = PointAttribute("LASBasicFlags", dt.U8)
ATTRIBUTE_EXTENDED_FLAGS = PointAttribute("LASExtendedFlags", dt.U16)
ATTRIBUTE_LOCAL_LAS_POSITION = PointAttribute("LASLocalPosition", dt.VEC3I32)


def _waveform_attributes() -> List[PointAttribute]:
    return [
        att.WAVE_PACKET_DESCRIPTOR_INDEX,
        att.WAVEFORM_DATA_OFFSET,
        att.WAVEFORM_PACKET_SIZE,
        att.RETURN_POINT_WAVEFORM_LOCATION,
        att.WAVEFORM_PARAMETERS,
    ]


def point_schema_from_las_format(
    fmt: LasPointFormat,
    exact_binary_representation: bool = False,
    extra_bytes_attributes: Optional[List[PointAttribute]] = None,
) -> PointSchema:
    """Build the schema for a LAS point format
    (reference ``point_layout_from_las_point_format`` las_layout.rs:66-130 and
    ``point_layout_from_las_metadata`` las_layout.rs:134-184).

    ``extra_bytes_attributes`` (from the Extra Bytes VLR) are appended
    packed(1); any undescribed extra bytes become an ``UndescribedExtraBytes``
    byte-array attribute.
    """
    attrs: List[PointAttribute] = []
    if exact_binary_representation:
        attrs.append(ATTRIBUTE_LOCAL_LAS_POSITION)
        attrs.append(att.INTENSITY)
        attrs.append(ATTRIBUTE_EXTENDED_FLAGS if fmt.is_extended
                     else ATTRIBUTE_BASIC_FLAGS)
        attrs.append(att.CLASSIFICATION)
        if fmt.is_extended:
            attrs += [att.USER_DATA, att.SCAN_ANGLE]
        else:
            attrs += [att.SCAN_ANGLE_RANK, att.USER_DATA]
        attrs.append(att.POINT_SOURCE_ID)
        if fmt.has_gps_time:
            attrs.append(att.GPS_TIME)
        if fmt.has_color:
            attrs.append(att.COLOR_RGB)
        if fmt.has_nir:
            attrs.append(att.NIR)
        if fmt.has_waveform:
            attrs += _waveform_attributes()
    else:
        # field order of LasPointFormatN (las_types.rs)
        attrs.append(att.POSITION_3D)
        attrs.append(att.INTENSITY)
        attrs += [att.RETURN_NUMBER, att.NUMBER_OF_RETURNS]
        if fmt.is_extended:
            attrs += [att.CLASSIFICATION_FLAGS, att.SCANNER_CHANNEL]
        attrs += [att.SCAN_DIRECTION_FLAG, att.EDGE_OF_FLIGHT_LINE,
                  att.CLASSIFICATION]
        if fmt.is_extended:
            attrs += [att.USER_DATA, att.SCAN_ANGLE, att.POINT_SOURCE_ID,
                      att.GPS_TIME]
        else:
            attrs += [att.SCAN_ANGLE_RANK, att.USER_DATA, att.POINT_SOURCE_ID]
            if fmt.has_gps_time:
                attrs.append(att.GPS_TIME)
        if fmt.has_color:
            attrs.append(att.COLOR_RGB)
        if fmt.has_nir:
            attrs.append(att.NIR)
        if fmt.has_waveform:
            attrs += _waveform_attributes()

    schema = PointSchema.from_attributes_packed(attrs)

    if fmt.extra_bytes:
        described = 0
        if extra_bytes_attributes:
            for eb in extra_bytes_attributes:
                schema.add_attribute(eb, 1)
                described += eb.size
        undescribed = fmt.extra_bytes - described
        if undescribed > 0:
            schema.add_attribute(
                PointAttribute("UndescribedExtraBytes", dt.byte_array(undescribed)), 1)
    return schema


#: all attribute names reachable from LAS formats 0-10 (las_layout.rs:240-270)
KNOWN_LAS_ATTRIBUTE_NAMES = frozenset({
    att.POSITION_3D.name, att.INTENSITY.name, att.RETURN_NUMBER.name,
    att.NUMBER_OF_RETURNS.name, att.CLASSIFICATION_FLAGS.name,
    att.SCANNER_CHANNEL.name, att.SCAN_DIRECTION_FLAG.name,
    att.EDGE_OF_FLIGHT_LINE.name, att.CLASSIFICATION.name,
    att.USER_DATA.name, att.SCAN_ANGLE.name, att.SCAN_ANGLE_RANK.name,
    att.POINT_SOURCE_ID.name, att.GPS_TIME.name, att.COLOR_RGB.name,
    att.NIR.name, att.WAVEFORM_DATA_OFFSET.name,
    att.WAVEFORM_PACKET_SIZE.name, att.WAVEFORM_PARAMETERS.name,
    att.WAVE_PACKET_DESCRIPTOR_INDEX.name,
    att.RETURN_POINT_WAVEFORM_LOCATION.name,
})


def is_known_las_attribute(attribute: PointAttribute) -> bool:
    """Name-only membership test (dtype ignored — conversion handles it),
    reference ``is_known_las_attribute`` las_layout.rs:240-270."""
    return attribute.name in KNOWN_LAS_ATTRIBUTE_NAMES


def las_format_from_point_schema(schema: PointSchema) -> LasPointFormat:
    """Best-matching LAS format for a schema
    (reference ``las_point_format_from_point_layout`` las_layout.rs:202-232)."""
    has = schema.has_attribute_with_name
    has_gps = has(att.GPS_TIME.name)
    has_color = has(att.COLOR_RGB.name)
    has_waveform = any(has(a.name) for a in _waveform_attributes())
    has_nir = has(att.NIR.name)
    extended = (has_nir or has(att.SCAN_ANGLE.name)
                or has(att.SCANNER_CHANNEL.name)
                or has(att.CLASSIFICATION_FLAGS.name))

    if extended:
        if has_waveform:
            number = 10 if (has_color or has_nir) else 9
        elif has_nir:
            number = 8
        elif has_color:
            number = 7
        else:
            number = 6
    else:
        if has_waveform:
            number = 5 if has_color else 4
        elif has_color:
            number = 3 if has_gps else 2
        elif has_gps:
            number = 1
        else:
            number = 0
    return LasPointFormat(number)
