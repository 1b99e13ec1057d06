"""LAS metadata: known VLR parsing + the Metadata surface.

Parity with pasture's ``LASMetadata``
(reference: pasture-io/src/las/las_metadata.rs:80-1078): bounds, point count,
format, plus parsed known VLRs — Classification Lookup (record 0), Text Area
Description (record 3) and the Extra Bytes VLR (record 4) whose entries map
to point attributes.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional

import numpy as np

from ...layout import dtypes as dt
from ...layout.attributes import PointAttribute
from ...math.aabb import AABB
from ..base import Metadata
from .header import LasHeader, LasPointFormat, LasVlr

__all__ = [
    "ExtraBytesEntry", "ExtraBytesVlr", "ClassificationLookup",
    "TextAreaDescription", "LasMetadata", "KNOWN_VLR_USER_ID",
]

KNOWN_VLR_USER_ID = "LASF_Spec"

#: extra-bytes data_type (1..10) -> PointDtype (las_metadata.rs ExtraBytesDataType)
_EXTRA_BYTES_DTYPES = {
    1: dt.U8, 2: dt.I8, 3: dt.U16, 4: dt.I16, 5: dt.U32,
    6: dt.I32, 7: dt.U64, 8: dt.I64, 9: dt.F32, 10: dt.F64,
}


@dataclasses.dataclass
class ExtraBytesEntry:
    """One 192-byte Extra Bytes VLR record (LAS 1.4 R14 §"Extra Bytes")."""

    data_type: int
    options: int
    name: str
    scale: float
    offset: float
    description: str
    min_value: bytes
    max_value: bytes
    no_data_value: bytes

    SIZE = 192

    # option bits (las_metadata.rs ExtraBytesOptions)
    @property
    def no_data_is_relevant(self) -> bool:
        return bool(self.options & 0x01)

    @property
    def min_is_relevant(self) -> bool:
        return bool(self.options & 0x02)

    @property
    def max_is_relevant(self) -> bool:
        return bool(self.options & 0x04)

    @property
    def use_scale(self) -> bool:
        return bool(self.options & 0x08)

    @property
    def use_offset(self) -> bool:
        return bool(self.options & 0x10)

    @property
    def dtype(self) -> dt.PointDtype:
        if self.data_type == 0:
            # untyped: the options field is the byte count
            return dt.byte_array(max(self.options, 1))
        if self.data_type in _EXTRA_BYTES_DTYPES:
            return _EXTRA_BYTES_DTYPES[self.data_type]
        raise ValueError(f"unsupported extra-bytes data type {self.data_type}")

    def get_point_attribute(self) -> PointAttribute:
        """Reference ``ExtraBytesEntry::get_point_attribute``
        (las_metadata.rs:508-515)."""
        return PointAttribute(self.name, self.dtype)

    @classmethod
    def parse(cls, raw: bytes) -> "ExtraBytesEntry":
        if len(raw) != cls.SIZE:
            raise ValueError(f"extra bytes entry must be {cls.SIZE} bytes")
        data_type = raw[2]
        options = raw[3]
        name = raw[4:36].split(b"\0", 1)[0].decode("ascii", errors="replace")
        # anytype[3] blocks: only the first 8 bytes carry the value
        no_data = raw[40:48]
        mn = raw[64:72]
        mx = raw[88:96]
        scale = struct.unpack_from("<d", raw, 112)[0]
        offset = struct.unpack_from("<d", raw, 136)[0]
        desc = raw[160:192].split(b"\0", 1)[0].decode("ascii", errors="replace")
        return cls(data_type, options, name, scale, offset, desc, mn, mx, no_data)

    def serialize(self) -> bytes:
        raw = bytearray(self.SIZE)
        raw[2] = self.data_type
        raw[3] = self.options
        raw[4:36] = self.name.encode("ascii")[:32].ljust(32, b"\0")
        raw[40:48] = self.no_data_value[:8].ljust(8, b"\0")
        raw[64:72] = self.min_value[:8].ljust(8, b"\0")
        raw[88:96] = self.max_value[:8].ljust(8, b"\0")
        struct.pack_into("<d", raw, 112, self.scale)
        struct.pack_into("<d", raw, 136, self.offset)
        raw[160:192] = self.description.encode("ascii")[:32].ljust(32, b"\0")
        return bytes(raw)

    @classmethod
    def for_attribute(cls, attribute: PointAttribute,
                      description: str = "") -> "ExtraBytesEntry":
        rev = {v.name: k for k, v in _EXTRA_BYTES_DTYPES.items()}
        if attribute.dtype.name in rev:
            data_type, options = rev[attribute.dtype.name], 0
        elif attribute.dtype.kind in ("bytes", "custom"):
            data_type, options = 0, attribute.dtype.size
        else:
            raise ValueError(
                f"dtype {attribute.dtype} not representable as LAS extra bytes")
        return cls(data_type, options, attribute.name, 0.0, 0.0, description,
                   b"\0" * 8, b"\0" * 8, b"\0" * 8)


@dataclasses.dataclass
class ExtraBytesVlr:
    """Extra Bytes VLR (record_id 4) — a list of entries."""

    entries: List[ExtraBytesEntry]

    RECORD_ID = 4

    @classmethod
    def parse(cls, vlr: LasVlr) -> "ExtraBytesVlr":
        if len(vlr.data) % ExtraBytesEntry.SIZE:
            raise ValueError("extra bytes VLR size not a multiple of 192")
        n = len(vlr.data) // ExtraBytesEntry.SIZE
        return cls([ExtraBytesEntry.parse(
            vlr.data[i * 192:(i + 1) * 192]) for i in range(n)])

    def to_vlr(self) -> LasVlr:
        return LasVlr(KNOWN_VLR_USER_ID, self.RECORD_ID, "extra bytes",
                      b"".join(e.serialize() for e in self.entries))


@dataclasses.dataclass
class ClassificationLookup:
    """Classification Lookup VLR (record_id 0): 256 x (class, description)
    (las_metadata.rs:102-135)."""

    entries: Dict[int, str]

    RECORD_ID = 0

    @classmethod
    def parse(cls, vlr: LasVlr) -> "ClassificationLookup":
        if len(vlr.data) != 256 * 16:
            raise ValueError("classification lookup VLR must be 4096 bytes")
        entries = {}
        for i in range(256):
            rec = vlr.data[i * 16:(i + 1) * 16]
            desc = rec[1:].split(b"\0", 1)[0].decode("ascii", errors="replace")
            if desc:
                entries[rec[0]] = desc
        return cls(entries)


@dataclasses.dataclass
class TextAreaDescription:
    """Text Area Description VLR (record_id 3) (las_metadata.rs:168-185)."""

    text: str

    RECORD_ID = 3

    @classmethod
    def parse(cls, vlr: LasVlr) -> "TextAreaDescription":
        return cls(vlr.data.split(b"\0", 1)[0].decode("utf-8", errors="replace"))


class LasMetadata(Metadata):
    """Metadata surface for a LAS/LAZ file (reference ``LASMetadata``)."""

    def __init__(self, header: LasHeader) -> None:
        self.header = header
        self._extra_bytes: Optional[ExtraBytesVlr] = None
        self._classification_lookup: Optional[ClassificationLookup] = None
        self._text_area: Optional[TextAreaDescription] = None
        for vlr in header.vlrs:
            if vlr.user_id != KNOWN_VLR_USER_ID:
                continue
            try:
                if vlr.record_id == ExtraBytesVlr.RECORD_ID:
                    self._extra_bytes = ExtraBytesVlr.parse(vlr)
                elif vlr.record_id == ClassificationLookup.RECORD_ID:
                    self._classification_lookup = ClassificationLookup.parse(vlr)
                elif vlr.record_id == TextAreaDescription.RECORD_ID:
                    self._text_area = TextAreaDescription.parse(vlr)
            except ValueError:
                pass  # tolerate malformed known VLRs, like the reference

    # ---- Metadata interface ---------------------------------------------------
    def bounds(self) -> Optional[AABB]:
        mn, mx = self.header.bounds
        if mn == mx == (0.0, 0.0, 0.0) and self.header.point_count == 0:
            return None
        return AABB.from_min_max_unchecked(mn, mx)

    def number_of_points(self) -> Optional[int]:
        return self.header.point_count

    def get_named_field(self, name: str) -> Optional[Any]:
        h = self.header
        fields = {
            "version": f"{h.version[0]}.{h.version[1]}",
            "point_format": h.point_format.number,
            "file_source_id": h.file_source_id,
            "global_encoding": h.global_encoding,
            "creation_day_of_year": h.creation_day_of_year,
            "creation_year": h.creation_year,
            "generating_software": h.generating_software,
            "system_identifier": h.system_identifier,
            "scale": h.scale,
            "offset": h.offset,
            "number_of_vlrs": len(h.vlrs),
            "text_area_description": self._text_area.text if self._text_area else None,
        }
        return fields.get(name)

    # ---- LAS specifics --------------------------------------------------------
    @property
    def point_format(self) -> LasPointFormat:
        return self.header.point_format

    def extra_bytes_vlr(self) -> Optional[ExtraBytesVlr]:
        return self._extra_bytes

    def classification_lookup(self) -> Optional[ClassificationLookup]:
        return self._classification_lookup

    def extra_bytes_attributes(self) -> List[PointAttribute]:
        if self._extra_bytes is None:
            return []
        return [e.get_point_attribute() for e in self._extra_bytes.entries]

    def __repr__(self) -> str:
        h = self.header
        return (f"LasMetadata(v{h.version[0]}.{h.version[1]}, "
                f"format={h.point_format.number}, points={h.point_count})")
