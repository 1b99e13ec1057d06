"""3D Tiles .pnts reader/writer (port of pasture_tpu/io/tiles3d/pnts.py).

Parity with pasture's PntsReader/PntsWriter
(reference: pasture-io/src/tiles3d/pnts_reader.rs:41-463 and
pnts_writer.rs:67-597):

* 28-byte binary header (magic ``pnts``) + FeatureTable JSON header +
  columnar binary body;
* point semantics read in spec order: POSITION (Vec3f32), RGBA (Vec4u8),
  RGB (Vec3u8), NORMAL (Vec3f32); beyond the reference (which TODOs them,
  pnts_reader.rs:131): POSITION_QUANTIZED, NORMAL_OCT16P, RGB565,
  BATCH_ID (-> PointID) and CONSTANT_RGBA;
* global semantics POINTS_LENGTH and RTC_CENTER; positions read either
  ``RelativeToCenter`` or ``Absolute`` (RTC_CENTER added, f64 math);
* the writer caches points in a *compatible layout* (only position, color,
  rgba, normal survive, with dtype conversion; other attributes are
  silently dropped — pnts_writer.rs:104-155) and writes everything on
  ``flush``.
"""

from __future__ import annotations

import enum
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ...buffers.host import HostPointBuffer
from ...layout import attributes as att
from ...layout import dtypes as dt
from ...layout.attributes import PointAttribute
from ...layout.conversion import convert_attribute_column
from ...layout.schema import PointSchema
from ...math.aabb import AABB
from ..base import Metadata, PointReader, PointWriter
from .feature_table import (
    FeatureTableDataReference,
    read_feature_table_header,
    write_feature_table_header,
)

__all__ = ["PntsReader", "PntsWriter", "PntsMetadata", "PntsReadPositionsMode",
           "oct16p_decode", "oct16p_encode"]

_HEADER = struct.Struct("<4sIIIIII")  # magic, version, byteLength, ftJSON, ftBin, btJSON, btBin

#: semantics in 3D Tiles spec order -> (attribute, wire dtype)
_SEMANTICS: List[Tuple[str, PointAttribute]] = [
    ("POSITION", att.POSITION_3D.with_dtype(dt.VEC3F32)),
    ("RGBA", att.COLOR_RGBA),
    ("RGB", att.COLOR_RGB.with_dtype(dt.VEC3U8)),
    ("NORMAL", att.NORMAL),
]


def oct16p_decode(enc: np.ndarray) -> np.ndarray:
    """Decode octahedron-encoded unit normals (NORMAL_OCT16P semantic).

    ``enc`` is (N, 2) uint8; returns (N, 3) float32 unit vectors.  The
    scheme is Cesium's ``AttributeCompression.octDecodeInRange`` with
    rangeMax=255 ("A Survey of Efficient Representations for Independent
    Unit Vectors", Cigolle et al. 2014).
    """
    e = enc.astype(np.float64) / 255.0 * 2.0 - 1.0
    x, y = e[:, 0], e[:, 1]
    z = 1.0 - np.abs(x) - np.abs(y)
    # signNotZero: fold the lower hemisphere back across the diagonals
    sx = np.where(x >= 0.0, 1.0, -1.0)
    sy = np.where(y >= 0.0, 1.0, -1.0)
    fold = z < 0.0
    x, y = (np.where(fold, (1.0 - np.abs(y)) * sx, x),
            np.where(fold, (1.0 - np.abs(x)) * sy, y))
    v = np.stack([x, y, z], axis=1)
    norm = np.linalg.norm(v, axis=1, keepdims=True)
    return (v / np.where(norm == 0.0, 1.0, norm)).astype(np.float32)


def oct16p_encode(normals: np.ndarray) -> np.ndarray:
    """Encode (N, 3) unit vectors to (N, 2) uint8 (inverse of
    :func:`oct16p_decode`; Cesium ``octEncodeInRange`` with rangeMax=255)."""
    v = np.asarray(normals, np.float64)
    inv_l1 = 1.0 / np.maximum(
        np.abs(v[:, 0]) + np.abs(v[:, 1]) + np.abs(v[:, 2]), 1e-30)
    x = v[:, 0] * inv_l1
    y = v[:, 1] * inv_l1
    lower = v[:, 2] < 0.0
    sx = np.where(x >= 0.0, 1.0, -1.0)
    sy = np.where(y >= 0.0, 1.0, -1.0)
    x, y = (np.where(lower, (1.0 - np.abs(y)) * sx, x),
            np.where(lower, (1.0 - np.abs(x)) * sy, y))
    enc = np.stack([x, y], axis=1)
    return np.clip(np.round((enc + 1.0) * 0.5 * 255.0), 0, 255).astype(
        np.uint8)


class PntsReadPositionsMode(enum.Enum):
    """How RTC_CENTER affects read positions (pnts_reader.rs:30-39)."""

    RELATIVE_TO_CENTER = "relative"
    ABSOLUTE = "absolute"


class PntsMetadata(Metadata):
    """Global PNTS semantics (pnts_reader.rs PntsMetadata)."""

    def __init__(self, points_length: int,
                 rtc_center: Optional[np.ndarray],
                 quantized_volume_offset=None, quantized_volume_scale=None,
                 constant_rgba=None, batch_length=None) -> None:
        self.points_length = points_length
        self.rtc_center = rtc_center
        self.quantized_volume_offset = quantized_volume_offset
        self.quantized_volume_scale = quantized_volume_scale
        self.constant_rgba = constant_rgba
        self.batch_length = batch_length

    def bounds(self) -> Optional[AABB]:
        return None

    def number_of_points(self) -> Optional[int]:
        return self.points_length

    def get_named_field(self, name: str) -> Optional[Any]:
        return {
            "rtc_center": self.rtc_center,
            "points_length": self.points_length,
            "batch_length": self.batch_length,
        }.get(name)


class PntsReader(PointReader):
    """Reader for 3D Tiles .pnts files."""

    def __init__(self, source: Union[str, Path, bytes],
                 read_positions_mode: PntsReadPositionsMode =
                 PntsReadPositionsMode.ABSOLUTE) -> None:
        if isinstance(source, (str, Path)):
            with open(source, "rb") as f:
                buf = f.read()
        else:
            buf = bytes(source)
        magic, version, byte_length, ftj, ftb, btj, btb = _HEADER.unpack_from(
            buf, 0)
        if magic != b"pnts":
            raise ValueError(f"invalid PNTS magic {magic!r}")
        self.version = version
        ft_header = read_feature_table_header(buf, _HEADER.size, ftj)

        pl = ft_header.pop("POINTS_LENGTH", None)
        if pl is None:
            raise ValueError("PNTS feature table has no POINTS_LENGTH")
        n = int(pl)
        rtc = ft_header.pop("RTC_CENTER", None)
        rtc = np.asarray(rtc, np.float64) if rtc is not None else None
        self._metadata = PntsMetadata(
            n, rtc,
            ft_header.pop("QUANTIZED_VOLUME_OFFSET", None),
            ft_header.pop("QUANTIZED_VOLUME_SCALE", None),
            ft_header.pop("CONSTANT_RGBA", None),
            ft_header.pop("BATCH_LENGTH", None))
        body = _HEADER.size + ftj
        schema = PointSchema()
        cols: Dict[str, np.ndarray] = {}
        for semantic, attribute in _SEMANTICS:
            ref = ft_header.pop(semantic, None)
            if ref is None:
                continue
            if not isinstance(ref, FeatureTableDataReference):
                raise ValueError(
                    f"PNTS attribute {semantic} must be a data reference")
            schema.add_attribute(attribute, 1)
            start = body + ref.byte_offset
            npdt = attribute.dtype.np_component_dtype
            cnt = n * attribute.dtype.num_components
            arr = np.frombuffer(buf, npdt, cnt, start)
            cols[attribute.name] = arr.reshape(
                (n,) + attribute.dtype.np_shape).copy()

        # quantized positions: u16 triples dequantized into the volume
        # (beyond the reference, which TODOs this — pnts_reader.rs:131)
        qref = ft_header.pop("POSITION_QUANTIZED", None)
        if qref is not None and att.POSITION_3D.name not in cols:
            off = self._metadata.quantized_volume_offset
            sc = self._metadata.quantized_volume_scale
            if off is None or sc is None:
                raise ValueError(
                    "POSITION_QUANTIZED requires QUANTIZED_VOLUME_OFFSET "
                    "and QUANTIZED_VOLUME_SCALE")
            if not isinstance(qref, FeatureTableDataReference):
                raise ValueError(
                    "PNTS attribute POSITION_QUANTIZED must be a data "
                    "reference")
            q = np.frombuffer(buf, np.uint16, n * 3,
                              body + qref.byte_offset).reshape(n, 3)
            pos = (np.asarray(off, np.float64)[None, :]
                   + q.astype(np.float64) / 65535.0
                   * np.asarray(sc, np.float64)[None, :]).astype(np.float32)
            schema.add_attribute(att.POSITION_3D.with_dtype(dt.VEC3F32), 1)
            cols[att.POSITION_3D.name] = pos

        # NORMAL_OCT16P: octahedron-encoded unit normals, 2 x u8 per point
        # (beyond the reference, which TODOs it — pnts_writer.rs:113-117).
        # Decode per the 3D Tiles / Cesium AttributeCompression scheme
        # (octDecodeInRange with rangeMax=255).
        nref = ft_header.pop("NORMAL_OCT16P", None)
        if nref is not None and att.NORMAL.name not in cols:
            if not isinstance(nref, FeatureTableDataReference):
                raise ValueError(
                    "PNTS attribute NORMAL_OCT16P must be a data reference")
            enc = np.frombuffer(buf, np.uint8, n * 2,
                                body + nref.byte_offset).reshape(n, 2)
            schema.add_attribute(att.NORMAL, 1)
            cols[att.NORMAL.name] = oct16p_decode(enc)

        # RGB565: 16-bit packed color, decoded to Vec3u8 when no wider
        # color semantic is present (beyond the reference, same TODO)
        c565 = ft_header.pop("RGB565", None)
        if (c565 is not None and att.COLOR_RGBA.name not in cols
                and att.COLOR_RGB.name not in cols):
            if not isinstance(c565, FeatureTableDataReference):
                raise ValueError(
                    "PNTS attribute RGB565 must be a data reference")
            v = np.frombuffer(buf, np.uint16, n, body + c565.byte_offset)
            r = ((v >> 11) & 0x1F).astype(np.float64) * (255.0 / 31.0)
            g = ((v >> 5) & 0x3F).astype(np.float64) * (255.0 / 63.0)
            b = (v & 0x1F).astype(np.float64) * (255.0 / 31.0)
            schema.add_attribute(att.COLOR_RGB.with_dtype(dt.VEC3U8), 1)
            cols[att.COLOR_RGB.name] = np.stack(
                [r, g, b], axis=1).round().astype(np.uint8)

        # BATCH_ID: per-point batch index -> PointID column (beyond the
        # reference, same TODO).  componentType defaults to UNSIGNED_SHORT
        # per the 3D Tiles PointCloud spec.
        bref = ft_header.pop("BATCH_ID", None)
        if bref is not None:
            if not isinstance(bref, FeatureTableDataReference):
                raise ValueError(
                    "PNTS attribute BATCH_ID must be a data reference")
            wire = {"UNSIGNED_BYTE": np.uint8, "UNSIGNED_SHORT": np.uint16,
                    "UNSIGNED_INT": np.uint32}.get(
                        bref.component_type or "UNSIGNED_SHORT")
            if wire is None:
                raise ValueError(
                    f"unsupported BATCH_ID componentType "
                    f"{bref.component_type!r}")
            ids = np.frombuffer(buf, wire, n, body + bref.byte_offset)
            schema.add_attribute(att.POINT_ID, 1)
            cols[att.POINT_ID.name] = ids.astype(np.uint64)

        # CONSTANT_RGBA: materialize as a per-point color column when no
        # explicit color semantic is present (spec: per-point color wins)
        crgba = self._metadata.constant_rgba
        if (crgba is not None and att.COLOR_RGBA.name not in cols
                and att.COLOR_RGB.name not in cols):
            schema.add_attribute(att.COLOR_RGBA, 1)
            cols[att.COLOR_RGBA.name] = np.broadcast_to(
                np.asarray(crgba, np.uint8)[None, :], (n, 4)).copy()

        self._schema = schema
        self._columns = cols
        self._mode = read_positions_mode
        self._cursor = 0

        if (self._mode is PntsReadPositionsMode.ABSOLUTE
                and rtc is not None and att.POSITION_3D.name in cols):
            pos = cols[att.POSITION_3D.name].astype(np.float64) + rtc[None, :]
            cols[att.POSITION_3D.name] = pos.astype(np.float32)

    def read_positions_mode(self) -> PntsReadPositionsMode:
        return self._mode

    def get_metadata(self) -> PntsMetadata:
        return self._metadata

    def get_default_point_schema(self) -> PointSchema:
        return self._schema

    def read(self, count: int, schema: Optional[PointSchema] = None
             ) -> HostPointBuffer:
        n = min(count, self._metadata.points_length - self._cursor)
        start, stop = self._cursor, self._cursor + n
        self._cursor = stop
        cols = {k: v[start:stop] for k, v in self._columns.items()}
        buf = HostPointBuffer(self._schema, cols, validate=False)
        if schema is not None and schema != self._schema:
            return buf.convert_schema(schema, fill_missing_with_default=True)
        return buf


class PntsWriter(PointWriter):
    """Write-on-flush .pnts writer (reference pnts_writer.rs:67-597)."""

    def __init__(self, target: Union[str, Path], schema: PointSchema,
                 rtc_center: Optional[np.ndarray] = None,
                 quantize_positions: bool = False,
                 compress_normals: bool = False) -> None:
        """``quantize_positions`` emits POSITION_QUANTIZED (u16 triples +
        QUANTIZED_VOLUME_OFFSET/SCALE; step 1/65535 ~ 1.5e-5 of the extent
        per axis, max round-to-nearest error ~7.6e-6) and
        ``compress_normals`` emits NORMAL_OCT16P (2 bytes/normal) — both
        compact wire forms the reference only TODOs
        (pnts_writer.rs:113-117); off by default for reference parity.

        Note BATCH_ID is read-only: the reader decodes it into PointID but
        the writer has no BATCH_ID path (the reference writer drops it
        too), so read-then-write loses batch IDs — a warning is emitted
        when a PointID column is dropped (see LIMITATIONS.md)."""
        self._target = target
        self.source_schema = schema
        self._rtc_center = (np.asarray(rtc_center, np.float64)
                            if rtc_center is not None else None)
        self._quantize_positions = quantize_positions
        self._compress_normals = compress_normals
        # compatible layout: the surviving semantics in spec order
        compatible = PointSchema()
        self._mapping: List[Tuple[str, PointAttribute]] = []
        for semantic, target_attr in _SEMANTICS:
            if schema.has_attribute_with_name(target_attr.name):
                compatible.add_attribute(target_attr, 1)
                self._mapping.append((semantic, target_attr))
        self._schema = compatible
        if schema.has_attribute_with_name(att.POINT_ID.name):
            import warnings
            warnings.warn(
                "PNTS writer has no BATCH_ID path: the PointID column "
                "will be dropped on write (BATCH_ID is read-only; see "
                "LIMITATIONS.md)", stacklevel=2)
        self._cache: List[HostPointBuffer] = []
        self._flushed = False

    def get_default_point_schema(self) -> PointSchema:
        return self._schema

    def write(self, buffer: HostPointBuffer) -> None:
        cols = {}
        for _, target_attr in self._mapping:
            src = buffer.schema.member(target_attr.name)
            cols[target_attr.name] = convert_attribute_column(
                buffer.columns[target_attr.name], src.dtype, target_attr.dtype)
        self._cache.append(HostPointBuffer(self._schema, cols, validate=False))

    def flush(self) -> None:
        if self._flushed:
            return
        self._flushed = True
        merged = (HostPointBuffer.concat(self._cache) if self._cache
                  else HostPointBuffer.empty(self._schema))
        n = len(merged)

        body_parts: List[bytes] = []
        header: Dict[str, Any] = {"POINTS_LENGTH": n}
        if self._rtc_center is not None:
            header["RTC_CENTER"] = [float(v) for v in self._rtc_center]
        offset = 0
        for semantic, target_attr in self._mapping:
            col = merged.columns[target_attr.name]
            if (semantic == "POSITION" and self._rtc_center is not None):
                col = (col.astype(np.float64)
                       - self._rtc_center[None, :]).astype(np.float32)
            if semantic == "POSITION" and self._quantize_positions and n:
                if not np.isfinite(col).all():
                    raise ValueError(
                        "quantize_positions requires finite positions "
                        "(NaN/Inf would corrupt the uint16 cast)")
                off64 = col.min(axis=0).astype(np.float64)
                extent = col.max(axis=0).astype(np.float64) - off64
                # degenerate axes get scale 1.0 (not a 1e-30 sentinel):
                # decoders compute off + q/65535*scale and q is 0 there
                sc64 = np.where(extent > 0.0, extent, 1.0)
                q = np.round((col.astype(np.float64) - off64[None, :])
                             / sc64[None, :] * 65535.0)
                col = np.clip(q, 0, 65535).astype(np.uint16)
                header["QUANTIZED_VOLUME_OFFSET"] = [float(v) for v in off64]
                header["QUANTIZED_VOLUME_SCALE"] = [float(v) for v in sc64]
                semantic = "POSITION_QUANTIZED"
            elif semantic == "NORMAL" and self._compress_normals:
                col = oct16p_encode(col)
                semantic = "NORMAL_OCT16P"
            raw = np.ascontiguousarray(col).tobytes()
            header[semantic] = FeatureTableDataReference(offset)
            body_parts.append(raw)
            pad = (-len(raw)) % 8
            body_parts.append(b"\0" * pad)
            offset += len(raw) + pad
        body = b"".join(body_parts)

        ft_json = write_feature_table_header(header, 8, _HEADER.size)
        total = _HEADER.size + len(ft_json) + len(body)
        head = _HEADER.pack(b"pnts", 1, total, len(ft_json), len(body), 0, 0)
        with open(self._target, "wb") as f:
            f.write(head)
            f.write(ft_json)
            f.write(body)

    def close(self) -> None:
        self.flush()
