"""LAS header / VLR binary model (LAS 1.0-1.4).

Hand-rolled little-endian parse like the reference's raw reader
(reference: pasture-io/src/las/raw_readers.rs:191-241 uses the las crate's
``raw::Header``), but vectorised with numpy structured dtypes so a header or
a VLR block decodes in one shot.  Writing mirrors reading bit for bit.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["LasPointFormat", "LasVlr", "LasHeader", "POINT_FORMAT_SIZES"]

#: wire size of point record formats 0..10 (LAS 1.4 spec table 7+)
POINT_FORMAT_SIZES = [20, 28, 26, 34, 57, 63, 30, 36, 38, 59, 67]


@dataclasses.dataclass(frozen=True)
class LasPointFormat:
    """Decoded point-format descriptor (the las crate's ``Format`` analog)."""

    number: int
    extra_bytes: int = 0

    def __post_init__(self):
        if not 0 <= self.number <= 10:
            raise ValueError(f"unsupported LAS point format {self.number}")

    @property
    def is_extended(self) -> bool:
        return self.number >= 6

    @property
    def has_gps_time(self) -> bool:
        return self.number in (1, 3, 4, 5) or self.number >= 6

    @property
    def has_color(self) -> bool:
        return self.number in (2, 3, 5, 7, 8, 10)

    @property
    def has_nir(self) -> bool:
        return self.number in (8, 10)

    @property
    def has_waveform(self) -> bool:
        return self.number in (4, 5, 9, 10)

    @property
    def base_size(self) -> int:
        return POINT_FORMAT_SIZES[self.number]

    @property
    def len(self) -> int:
        return self.base_size + self.extra_bytes

    def offset_to_extra_bytes(self) -> Optional[int]:
        """Reference ``offset_to_extra_bytes`` (las_layout.rs:28-35)."""
        return self.base_size if self.extra_bytes else None


_VLR_HEADER = struct.Struct("<H16sHH32s")
_EVLR_HEADER = struct.Struct("<H16sHQ32s")


@dataclasses.dataclass
class LasVlr:
    """A (extended) variable length record."""

    user_id: str
    record_id: int
    description: str
    data: bytes
    reserved: int = 0

    @staticmethod
    def _decode_str(raw: bytes) -> str:
        return raw.split(b"\0", 1)[0].decode("ascii", errors="replace")

    @classmethod
    def parse(cls, buf: bytes, offset: int, extended: bool = False
              ) -> Tuple["LasVlr", int]:
        hdr = _EVLR_HEADER if extended else _VLR_HEADER
        reserved, user_id, record_id, length, desc = hdr.unpack_from(buf, offset)
        start = offset + hdr.size
        data = bytes(buf[start:start + length])
        if len(data) != length:
            raise ValueError("VLR payload truncated")
        return cls(cls._decode_str(user_id), record_id, cls._decode_str(desc),
                   data, reserved), start + length

    def serialize(self, extended: bool = False) -> bytes:
        hdr = _EVLR_HEADER if extended else _VLR_HEADER
        head = hdr.pack(self.reserved,
                        self.user_id.encode("ascii")[:16].ljust(16, b"\0"),
                        self.record_id, len(self.data),
                        self.description.encode("ascii")[:32].ljust(32, b"\0"))
        return head + self.data

    def wire_size(self, extended: bool = False) -> int:
        return (_EVLR_HEADER if extended else _VLR_HEADER).size + len(self.data)


# base header through LAS 1.2 (227 bytes)
_HDR_BASE = struct.Struct(
    "<4sHH16sBB32s32sHHHIIBHI" + "5I" + "12d")
assert _HDR_BASE.size == 227


@dataclasses.dataclass
class LasHeader:
    """Parsed LAS file header (all versions; 1.4 fields optional)."""

    version: Tuple[int, int] = (1, 4)
    point_format: LasPointFormat = LasPointFormat(0)
    point_record_length: int = 20
    point_count: int = 0
    points_by_return: Tuple[int, ...] = (0,) * 15
    scale: Tuple[float, float, float] = (0.001, 0.001, 0.001)
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    #: ((min_x, min_y, min_z), (max_x, max_y, max_z))
    bounds: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
        (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))
    file_source_id: int = 0
    global_encoding: int = 0
    project_id: bytes = b"\0" * 16
    system_identifier: str = "pasture_tpu"
    generating_software: str = "pasture_tpu"
    creation_day_of_year: int = 0
    creation_year: int = 0
    offset_to_point_data: int = 0
    header_size: int = 0
    is_compressed: bool = False
    waveform_data_start: int = 0
    evlr_start: int = 0
    num_evlrs: int = 0
    vlrs: List[LasVlr] = dataclasses.field(default_factory=list)
    #: extended VLRs (LAS 1.4, stored after the point data)
    evlrs: List[LasVlr] = dataclasses.field(default_factory=list)
    #: raw bytes between the last VLR and the point data (reference
    #: ``vlr_padding``, raw_readers.rs:198-218)
    vlr_padding: bytes = b""

    # ---- parsing --------------------------------------------------------------
    @classmethod
    def parse(cls, buf: bytes) -> "LasHeader":
        if len(buf) < 227:
            raise ValueError("file too small to contain a LAS header")
        (sig, file_source_id, global_encoding, project_id, ver_major,
         ver_minor, system_id, software, day, year, header_size,
         offset_to_points, num_vlrs, raw_format, record_length,
         legacy_count, *rest) = _HDR_BASE.unpack_from(buf, 0)
        if sig != b"LASF":
            raise ValueError(f"invalid LAS signature {sig!r}")
        legacy_by_return = tuple(rest[:5])
        doubles = rest[5:]
        scale = tuple(doubles[0:3])
        off = tuple(doubles[3:6])
        # LAS stores max/min interleaved per axis: max_x min_x max_y min_y ...
        max_x, min_x, max_y, min_y, max_z, min_z = doubles[6:12]

        is_compressed = bool(raw_format & 0x80)
        format_number = raw_format & 0x3F

        waveform_start = 0
        evlr_start = 0
        num_evlrs = 0
        point_count = legacy_count
        by_return: Tuple[int, ...] = legacy_by_return + (0,) * 10
        pos = 227
        if (ver_major, ver_minor) >= (1, 3):
            (waveform_start,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
        if (ver_major, ver_minor) >= (1, 4):
            evlr_start, num_evlrs, count64 = struct.unpack_from("<QIQ", buf, pos)
            pos += 20
            by_return64 = struct.unpack_from("<15Q", buf, pos)
            pos += 120
            if count64:
                point_count = count64
                by_return = tuple(by_return64)

        # VLRs follow the declared header size
        vlrs = []
        vpos = header_size
        for _ in range(num_vlrs):
            vlr, vpos = LasVlr.parse(buf, vpos)
            vlrs.append(vlr)
        vlr_padding = bytes(buf[vpos:offset_to_points]) if offset_to_points > vpos else b""

        # extended VLRs live after the point data (LAS 1.4)
        evlrs = []
        if num_evlrs and 0 < evlr_start < len(buf):
            epos = evlr_start
            for _ in range(num_evlrs):
                evlr, epos = LasVlr.parse(buf, epos, extended=True)
                evlrs.append(evlr)

        extra = record_length - POINT_FORMAT_SIZES[format_number]
        if extra < 0:
            raise ValueError(
                f"point record length {record_length} below format "
                f"{format_number} minimum {POINT_FORMAT_SIZES[format_number]}")

        return cls(
            version=(ver_major, ver_minor),
            point_format=LasPointFormat(format_number, extra),
            point_record_length=record_length,
            point_count=point_count,
            points_by_return=by_return,
            scale=scale, offset=off,
            bounds=((min_x, min_y, min_z), (max_x, max_y, max_z)),
            file_source_id=file_source_id,
            global_encoding=global_encoding,
            project_id=project_id,
            system_identifier=LasVlr._decode_str(system_id),
            generating_software=LasVlr._decode_str(software),
            creation_day_of_year=day, creation_year=year,
            offset_to_point_data=offset_to_points,
            header_size=header_size,
            is_compressed=is_compressed,
            waveform_data_start=waveform_start,
            evlr_start=evlr_start, num_evlrs=num_evlrs,
            vlrs=vlrs, evlrs=evlrs, vlr_padding=vlr_padding,
        )

    # ---- serialisation --------------------------------------------------------
    def _computed_header_size(self) -> int:
        v = self.version
        if v >= (1, 4):
            return 375
        if v >= (1, 3):
            return 235
        return 227

    def serialize(self) -> bytes:
        """Serialise header + VLRs + padding (everything before point data)."""
        hs = self._computed_header_size()
        vlr_bytes = b"".join(v.serialize() for v in self.vlrs)
        offset_to_points = hs + len(vlr_bytes) + len(self.vlr_padding)

        use_legacy = self.version < (1, 4) or self.point_count < 2**32
        legacy_count = self.point_count if (use_legacy and self.point_count < 2**32) else 0
        # legacy per-return counts: first 5, only if they fit (LAS 1.4 §2.2)
        legacy_by_return = []
        for i in range(5):
            c = self.points_by_return[i] if i < len(self.points_by_return) else 0
            legacy_by_return.append(c if (use_legacy and c < 2**32) else 0)
        if self.version >= (1, 4) and self.point_format.number >= 6:
            legacy_count = 0
            legacy_by_return = [0] * 5

        raw_format = self.point_format.number | (0x80 if self.is_compressed else 0)
        (mn, mx) = self.bounds
        base = _HDR_BASE.pack(
            b"LASF", self.file_source_id, self.global_encoding,
            self.project_id[:16].ljust(16, b"\0"),
            self.version[0], self.version[1],
            self.system_identifier.encode("ascii")[:32].ljust(32, b"\0"),
            self.generating_software.encode("ascii")[:32].ljust(32, b"\0"),
            self.creation_day_of_year, self.creation_year,
            hs, offset_to_points, len(self.vlrs),
            raw_format, self.point_record_length, legacy_count,
            *legacy_by_return,
            *self.scale, *self.offset,
            mx[0], mn[0], mx[1], mn[1], mx[2], mn[2],
        )
        tail = b""
        if self.version >= (1, 3):
            tail += struct.pack("<Q", self.waveform_data_start)
        if self.version >= (1, 4):
            br = list(self.points_by_return[:15])
            br += [0] * (15 - len(br))
            tail += struct.pack("<QIQ", self.evlr_start, self.num_evlrs,
                                self.point_count)
            tail += struct.pack("<15Q", *br)
        out = base + tail
        assert len(out) == hs, (len(out), hs)
        return out + vlr_bytes + self.vlr_padding

    # ---- convenience ----------------------------------------------------------
    def find_vlr(self, user_id: str, record_id: int) -> Optional[LasVlr]:
        for v in self.vlrs:
            if v.user_id == user_id and v.record_id == record_id:
                return v
        return None

    @property
    def scale_np(self) -> np.ndarray:
        return np.asarray(self.scale, np.float64)

    @property
    def offset_np(self) -> np.ndarray:
        return np.asarray(self.offset, np.float64)
