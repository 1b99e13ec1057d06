"""LAS/LAZ reader.

Columnar re-design of pasture's raw LAS read path
(reference: pasture-io/src/las/raw_readers.rs:175-416 and the LASReader
facade, las_reader.rs:15-171).  Instead of per-point record parsing, the
point block is mapped as one numpy structured view of the exact wire schema
(zero parse — the ``fast_las_parsing.rs`` mmap path is the *default* here)
and decoded with vectorised column transforms.

LAZ files decode through the native LASzip codec
(pasture_tpu_torch.native.laszip) chunk-parallel on host threads.
"""

from __future__ import annotations

import io as _io
import mmap
import os
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from ...buffers.host import HostPointBuffer
from ...layout.schema import PointSchema
from ..base import PointReader, SeekToPoint
from .conversion import get_default_las_converter
from .header import LasHeader
from .layout import point_schema_from_las_format
from .metadata import LasMetadata

__all__ = ["LasReader", "path_is_compressed_las_file"]


def path_is_compressed_las_file(path: Union[str, Path]) -> bool:
    """Extension-based LAZ detection (reference las_reader.rs:15-26)."""
    return Path(path).suffix.lower() == ".laz"


class LasReader(PointReader, SeekToPoint):
    """Reader for LAS and LAZ files.

    ``point_schema_matches_memory_layout=True`` makes the default schema the
    exact binary wire schema (local i32 positions, packed flags) — the
    fastest path, no decode at all (reference ``LASReader::from_path``
    flag, las_reader.rs:91).
    """

    def __init__(self, source: Union[str, Path, bytes, bytearray, _io.BytesIO],
                 point_schema_matches_memory_layout: bool = False,
                 compressed: Optional[bool] = None) -> None:
        self._mmap = None
        self._file = None
        if isinstance(source, (str, Path)):
            if compressed is None:
                compressed = path_is_compressed_las_file(source)
            self._file = open(source, "rb")
            try:
                self._mmap = mmap.mmap(self._file.fileno(), 0,
                                       access=mmap.ACCESS_READ)
                buf = memoryview(self._mmap)
            except (ValueError, OSError):  # empty file etc.
                buf = self._file.read()
        elif isinstance(source, _io.BytesIO):
            buf = source.getbuffer()
        else:
            buf = memoryview(source)
        self._buf = buf

        self.header = LasHeader.parse(buf)
        if compressed is None:
            compressed = self.header.is_compressed
        self.metadata = LasMetadata(self.header)

        fmt = self.header.point_format
        extra_attrs = self.metadata.extra_bytes_attributes()
        self._exact_schema = point_schema_from_las_format(
            fmt, exact_binary_representation=True,
            extra_bytes_attributes=extra_attrs)
        if self._exact_schema.point_size != self.header.point_record_length:
            raise ValueError(
                f"wire schema size {self._exact_schema.point_size} != declared "
                f"record length {self.header.point_record_length}")
        self._default_schema = (
            self._exact_schema if point_schema_matches_memory_layout
            else point_schema_from_las_format(
                fmt, exact_binary_representation=False,
                extra_bytes_attributes=extra_attrs))

        n = self.header.point_count
        if compressed:
            from ...native.laszip import LazDecompressor
            self._records = None
            self._laz = LazDecompressor(self._buf, self.header)
        else:
            self._laz = None
            # zero-copy structured view over the point block
            self._records = np.frombuffer(
                self._buf, dtype=self._exact_schema.to_numpy_dtype(),
                count=n, offset=self.header.offset_to_point_data)
        self._cursor = 0
        self._converters: Dict[PointSchema, object] = {}

    # ---- PointReader ----------------------------------------------------------
    def get_metadata(self) -> LasMetadata:
        return self.metadata

    def las_metadata(self) -> LasMetadata:
        return self.metadata

    def get_default_point_schema(self) -> PointSchema:
        return self._default_schema

    def remaining_points(self) -> int:
        """Reference ``LASReaderBase::remaining_points``."""
        return self.header.point_count - self._cursor

    def read(self, count: int, schema: Optional[PointSchema] = None
             ) -> HostPointBuffer:
        if schema is None:
            schema = self._default_schema
        n = min(count, self.remaining_points())
        start, stop = self._cursor, self._cursor + n
        self._cursor = stop

        if self._laz is not None:
            raw = self._laz.decompress_points(start, n)
            rec = np.frombuffer(raw, dtype=self._exact_schema.to_numpy_dtype(),
                                count=n)
        else:
            rec = self._records[start:stop]

        if schema != self._exact_schema and n >= 16384:
            out = self._read_fused(rec, n, schema)
            if out is not None:
                return out

        columns, owned = self._extract_columns(rec, n)
        if schema == self._exact_schema:
            cols = {k: np.ascontiguousarray(v) for k, v in columns.items()}
            return HostPointBuffer(self._exact_schema, cols, validate=False)

        conv = self._converters.get(schema)
        if conv is None:
            conv = get_default_las_converter(self._exact_schema, schema,
                                             self.header)
            self._converters[schema] = conv
        out_cols = conv.convert(columns, assume_owned=owned)
        return HostPointBuffer(schema, out_cols, validate=False)

    # ---- fused native converting read -----------------------------------------
    _BASIC_FLAG_NAMES = ("ReturnNumber", "NumberOfReturns",
                         "ScanDirectionFlag", "EdgeOfFlightLine")
    _EXT_FLAG_NAMES = ("ReturnNumber", "NumberOfReturns",
                       "ClassificationFlags", "ScannerChannel",
                       "ScanDirectionFlag", "EdgeOfFlightLine")

    def _fused_plan(self, schema):
        """Per-member routing for the ONE-pass native converting read
        (laz_las_convert): position decode + flag fan-out + pass-through
        copies together, the record bytes hot in cache exactly once.
        Returns None when the schema needs transforms the fused pass
        doesn't cover (the SchemaConverter path remains the oracle)."""
        from ...layout import attributes as att
        wire = self._exact_schema
        wire_members = {m.name: m for m in wire.members}
        basic = wire_members.get("LASBasicFlags")
        ext = wire_members.get("LASExtendedFlags")
        flag_names = (self._EXT_FLAG_NAMES if ext is not None
                      else self._BASIC_FLAG_NAMES)
        flags_offset = (ext.offset if ext is not None
                        else (basic.offset if basic is not None else None))
        flags_mode = 2 if ext is not None else (1 if basic is not None
                                                else 0)
        pos_wire = wire_members.get("LASLocalPosition")

        plan = {"pos_target": None, "pos_f32": False,
                "flags_offset": flags_offset, "flags_mode": flags_mode,
                "want_flags": [False] * len(flag_names),
                "flag_targets": [None] * len(flag_names),
                "fields": [], "field_targets": [], "zero": []}
        for m in schema.members:
            if m.name == att.POSITION_3D.name:
                if pos_wire is None or m.dtype.name not in ("Vec3f64",
                                                            "Vec3f32"):
                    return None
                plan["pos_target"] = m
                plan["pos_f32"] = m.dtype.name == "Vec3f32"
                continue
            if flags_mode and m.name in flag_names:
                i = flag_names.index(m.name)
                if np.dtype(m.dtype.np_component_dtype) != np.uint8 \
                        or m.dtype.np_shape != ():
                    return None
                plan["want_flags"][i] = True
                plan["flag_targets"][i] = m
                continue
            w = wire_members.get(m.name)
            if w is None:
                plan["zero"].append(m)
                continue
            if w.dtype.name != m.dtype.name:
                return None   # dtype conversion: fall back to converter
            plan["fields"].append((w.offset, m.dtype.np_component_dtype,
                                   w.size))
            plan["field_targets"].append(m)
        return plan

    def _read_fused(self, rec, n: int, schema):
        try:
            from ...native.laszip import _native, las_convert_fused
            if _native() is None:
                return None
        except Exception:
            return None
        plan = self._fused_plans.get(schema) if hasattr(
            self, "_fused_plans") else None
        if plan is None:
            if not hasattr(self, "_fused_plans"):
                self._fused_plans = {}
            if schema in self._fused_plans:   # cached "not applicable"
                return None
            plan = self._fused_plan(schema)
            self._fused_plans[schema] = plan
            if plan is None:
                return None
        pos_wire_offset = None
        if plan["pos_target"] is not None:
            pos_wire_offset = next(
                m.offset for m in self._exact_schema.members
                if m.name == "LASLocalPosition")
        pos, flags, fields = las_convert_fused(
            np.ascontiguousarray(rec) if not rec.flags.c_contiguous else rec,
            n, self._exact_schema.point_size, pos_wire_offset,
            self.header.scale_np, self.header.offset_np,
            plan["flags_offset"], plan["flags_mode"],
            len(plan["want_flags"]), plan["want_flags"], plan["fields"])
        cols = {}
        if plan["pos_target"] is not None:
            cols[plan["pos_target"].name] = (
                pos.astype(np.float32) if plan["pos_f32"] else pos)
        for m, arr in zip(plan["flag_targets"], flags):
            if m is not None:
                cols[m.name] = arr
        for m, arr in zip(plan["field_targets"], fields):
            shape = m.dtype.np_shape
            cols[m.name] = arr if shape == () else arr.reshape((n,) + shape)
        for m in plan["zero"]:
            cols[m.name] = np.zeros((n,) + m.dtype.np_shape,
                                    m.dtype.np_component_dtype)
        return HostPointBuffer(schema, cols, validate=False)

    def _extract_columns(self, rec: np.ndarray, n: int) -> Dict[str, np.ndarray]:
        """Record -> contiguous columns.  numpy's strided field access
        re-walks the full record block once PER FIELD; for large reads
        the native C++ deinterleaver (laszip.cpp laz_deinterleave) walks
        it once per L2 block and emits every column, threads across row
        ranges — the host-ingest hot loop (SURVEY §3.1)."""
        if n >= 16384:
            try:
                from ...native.laszip import _native, deinterleave_records
                native = _native()
            except Exception:
                native = None
            if native is not None:
                members = self._exact_schema.members
                fields = [(m.offset, m.dtype.np_component_dtype, m.size)
                          for m in members]
                outs = deinterleave_records(
                    rec, n, self._exact_schema.point_size, fields)
                cols = {}
                for m, arr in zip(members, outs):
                    shape = m.dtype.np_shape
                    cols[m.name] = (arr if shape == ()
                                    else arr.reshape((n,) + shape))
                return cols, True   # fresh owned buffers
        return ({m.name: rec[m.name]
                 for m in self._exact_schema.members}, False)

    # ---- SeekToPoint ----------------------------------------------------------
    def seek_point(self, index: int) -> int:
        """Point-granular seek (reference raw_readers.rs:394-416)."""
        self._cursor = max(0, min(index, self.header.point_count))
        return self._cursor

    def point_index(self) -> int:
        return self._cursor

    def point_count(self) -> int:
        return self.header.point_count

    def close(self) -> None:
        self._records = None
        self._buf = None
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                # zero-copy columns handed out by read() still reference
                # the mapping (the mmap zero-parse default path); dropping
                # our reference keeps them valid — the OS mapping is
                # released when the last view is garbage-collected.
                # Without this, `read_all(path)` (which closes on context
                # exit) would crash for exact-schema mmap reads.
                pass
            self._mmap = None
        if self._file is not None:
            self._file.close()
            self._file = None
