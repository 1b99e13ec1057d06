"""LAS decode/encode conversions: position transform + bitfield (un)packing.

Semantic parity with pasture's default LAS converter
(reference: pasture-io/src/las/raw_readers.rs:31-167) and write helpers
(write_helpers.rs:10-70), but vectorised over whole columns instead of per
point:

* read: local Vec3i32 -> world position via ``pos*scale + offset`` (exact f64,
  applied *after* the i32->f64 conversion, as in the reference);
* read: bitfield fan-out of the packed basic (u8) / extended (u16) flags into
  the unpacked flag attributes, masks applied in the source integer domain;
* write: world f64 -> local i32 via ``trunc((world - offset) / scale)`` with
  an out-of-range error (reference ``write_position_as_las_position``);
* write: flag packing (reference ``write_las_bit_attributes``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ...layout import attributes as att
from ...layout.conversion import SchemaConverter, convert_attribute_column
from ...layout.schema import PointSchema
from .header import LasHeader
from .layout import (
    ATTRIBUTE_BASIC_FLAGS,
    ATTRIBUTE_EXTENDED_FLAGS,
    ATTRIBUTE_LOCAL_LAS_POSITION,
)

__all__ = [
    "get_default_las_converter",
    "world_to_local_positions",
    "local_to_world_positions",
    "pack_basic_flags", "pack_extended_flags",
    "build_wire_columns",
]


def local_to_world_positions(local: np.ndarray, scale: np.ndarray,
                             offset: np.ndarray) -> np.ndarray:
    """``pos * scale + offset`` in f64 (raw_readers.rs:39-50)."""
    return local.astype(np.float64) * scale[None, :] + offset[None, :]


def world_to_local_positions(world: np.ndarray, scale: np.ndarray,
                             offset: np.ndarray) -> np.ndarray:
    """World f64 -> local i32, truncating toward zero; raises if any
    coordinate exceeds i32 range (write_helpers.rs:10-24 panics there)."""
    local = np.trunc((np.asarray(world, np.float64) - offset[None, :])
                     / scale[None, :])
    if np.any(local > np.iinfo(np.int32).max) or np.any(local < np.iinfo(np.int32).min):
        raise ValueError(
            "position out of bounds for the current LAS offset and scale")
    return local.astype(np.int32)


# ---- read-direction converter --------------------------------------------------

def _basic_flag_extractors():
    # (target attribute, mask fn on the packed u8 column)
    return [
        (att.RETURN_NUMBER, lambda f: f & 0b111),
        (att.NUMBER_OF_RETURNS, lambda f: (f >> 3) & 0b111),
        (att.SCAN_DIRECTION_FLAG, lambda f: (f >> 6) & 0b1),
        (att.EDGE_OF_FLIGHT_LINE, lambda f: (f >> 7) & 0b1),
    ]


def _extended_flag_extractors():
    return [
        (att.RETURN_NUMBER, lambda f: f & 0b1111),
        (att.NUMBER_OF_RETURNS, lambda f: (f >> 4) & 0b1111),
        (att.CLASSIFICATION_FLAGS, lambda f: (f >> 8) & 0b1111),
        (att.SCANNER_CHANNEL, lambda f: (f >> 12) & 0b11),
        (att.SCAN_DIRECTION_FLAG, lambda f: (f >> 14) & 0b1),
        (att.EDGE_OF_FLIGHT_LINE, lambda f: (f >> 15) & 0b1),
    ]


def _decode_positions(p: np.ndarray, scale: np.ndarray,
                      offset: np.ndarray) -> np.ndarray:
    """i32 locals -> f64 world; large contiguous columns go through the
    threaded native decode (identical f64 arithmetic)."""
    if (p.dtype == np.int32 and len(p) >= 16384
            and p.flags.c_contiguous):
        try:
            from ...native.laszip import _native, decode_positions_f64
            if _native() is not None:
                return decode_positions_f64(p, scale, offset)
        except Exception:
            pass
    return p * scale[None, :] + offset[None, :]


def get_default_las_converter(
    raw_las_schema: PointSchema,
    target_schema: PointSchema,
    header: LasHeader,
) -> SchemaConverter:
    """Converter from the exact wire schema into any target schema
    (reference ``get_default_las_converter``, raw_readers.rs:31-167).

    Unmapped target attributes are zero-filled; position and flag targets get
    custom mappings with the LAS-specific transforms.
    """
    conv = SchemaConverter.for_schemas_with_default(raw_las_schema, target_schema)

    pos_member = target_schema.get(att.POSITION_3D.name)
    if pos_member is not None:
        scale, offset = header.scale_np, header.offset_np
        dt_name = pos_member.dtype.name
        # consumes_raw: the transforms receive the RAW i32 locals — the
        # reference converts i32 -> f64 BEFORE scaling (raw_readers.rs:
        # 39-58); a prior componentwise cast would both truncate large
        # coordinates for f32 targets and keep the native threaded
        # decode (laszip.laz_decode_positions) from ever seeing i32
        if dt_name == "Vec3f64":
            conv.set_custom_mapping_with_transformation(
                ATTRIBUTE_LOCAL_LAS_POSITION, pos_member.attribute,
                lambda p: _decode_positions(p, scale, offset),
                applies_to_source=True, consumes_raw=True)
        elif dt_name == "Vec3f32":
            # f64 math, rounded to f32 at the end (raw_readers.rs:51-58)
            conv.set_custom_mapping_with_transformation(
                ATTRIBUTE_LOCAL_LAS_POSITION, pos_member.attribute,
                lambda p: _decode_positions(p, scale,
                                            offset).astype(np.float32),
                applies_to_source=True, consumes_raw=True)
        else:
            raise ValueError(
                f"invalid datatype {dt_name} for POSITION_3D: only Vec3f64 "
                f"and Vec3f32 are supported")

    if raw_las_schema.has_attribute(ATTRIBUTE_BASIC_FLAGS):
        source, extractors = ATTRIBUTE_BASIC_FLAGS, _basic_flag_extractors()
    elif raw_las_schema.has_attribute(ATTRIBUTE_EXTENDED_FLAGS):
        source, extractors = ATTRIBUTE_EXTENDED_FLAGS, _extended_flag_extractors()
    else:
        source, extractors = None, []
    if source is not None:
        for target_attr, fn in extractors:
            member = target_schema.get(target_attr.name)
            if member is not None:
                conv.set_custom_mapping_with_transformation(
                    source, member.attribute, fn, applies_to_source=True)
    return conv


# ---- write-direction packing ---------------------------------------------------

def pack_basic_flags(columns: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """Pack unpacked flag columns into the basic u8 flags
    (write_helpers.rs:27-40).  Missing columns default to zero."""
    def col(name):
        c = columns.get(name)
        return np.zeros(n, np.uint8) if c is None else c.astype(np.uint8)

    return ((col(att.RETURN_NUMBER.name) & 0b111)
            | ((col(att.NUMBER_OF_RETURNS.name) & 0b111) << 3)
            | ((col(att.SCAN_DIRECTION_FLAG.name) & 0b1) << 6)
            | ((col(att.EDGE_OF_FLIGHT_LINE.name) & 0b1) << 7)).astype(np.uint8)


def pack_extended_flags(columns: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """Pack into the extended u16 flags (write_helpers.rs:41-52)."""
    def col(name):
        c = columns.get(name)
        return np.zeros(n, np.uint16) if c is None else c.astype(np.uint16)

    return ((col(att.RETURN_NUMBER.name) & 0b1111)
            | ((col(att.NUMBER_OF_RETURNS.name) & 0b1111) << 4)
            | ((col(att.CLASSIFICATION_FLAGS.name) & 0b1111) << 8)
            | ((col(att.SCANNER_CHANNEL.name) & 0b11) << 12)
            | ((col(att.SCAN_DIRECTION_FLAG.name) & 0b1) << 14)
            | ((col(att.EDGE_OF_FLIGHT_LINE.name) & 0b1) << 15)).astype(np.uint16)


def build_wire_columns(
    source_schema: PointSchema,
    columns: Dict[str, np.ndarray],
    wire_schema: PointSchema,
    header: LasHeader,
) -> Dict[str, np.ndarray]:
    """Convert arbitrary-schema SoA columns into the exact wire schema
    (the inverse of :func:`get_default_las_converter`; plays the role of the
    reference's per-attribute ``ReaderFn`` closures, raw_writers.rs:365+).

    Attributes absent from the source are zero-filled; present ones are
    dtype-converted with Rust-``as`` semantics.
    """
    n = 0
    for v in columns.values():
        n = len(v)
        break
    out: Dict[str, np.ndarray] = {}
    for m in wire_schema.members:
        name = m.name
        if name == ATTRIBUTE_LOCAL_LAS_POSITION.name:
            world = columns.get(att.POSITION_3D.name)
            if world is None:
                out[name] = np.zeros((n, 3), np.int32)
            else:
                src_dt = source_schema.attribute(att.POSITION_3D.name).dtype
                world64 = convert_attribute_column(world, src_dt, att.POSITION_3D.dtype)
                out[name] = world_to_local_positions(
                    world64, header.scale_np, header.offset_np)
        elif name == ATTRIBUTE_BASIC_FLAGS.name:
            if name in columns:  # source already packed
                out[name] = columns[name].astype(np.uint8)
            else:
                out[name] = pack_basic_flags(columns, n)
        elif name == ATTRIBUTE_EXTENDED_FLAGS.name:
            if name in columns:
                out[name] = columns[name].astype(np.uint16)
            else:
                out[name] = pack_extended_flags(columns, n)
        elif name in columns:
            src_dt = source_schema.attribute(name).dtype
            out[name] = convert_attribute_column(columns[name], src_dt, m.dtype)
        else:
            out[name] = np.zeros((n,) + m.dtype.np_shape,
                                 m.dtype.np_component_dtype)
    return out
