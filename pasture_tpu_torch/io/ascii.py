"""ASCII point-cloud I/O (parity: pasture-io/src/ascii/).

LAStools-style format strings drive both reading and writing
(reference ascii_format_util.rs:28-85)::

    s skip | x y z position | i intensity | r return# | n #returns
    c classification | u user data | R G B color | t gps time
    p point source id | e edge of flight line | d scan direction
    a scan angle rank | I nir

Reading parses line by line against an explicit delimiter, raising on
malformed literals (raw_reader.rs:69-320); writing formats with a
configurable delimiter (default ``", "``) and float precision (default 5)
with trailing-zero trimming (raw_writer.rs:14-200).  There is no metadata
(bounds/count unknown before parsing — ascii_metadata.rs parity).
"""

from __future__ import annotations

import io as _io
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..buffers.host import HostPointBuffer
from ..layout import attributes as att
from ..layout.attributes import PointAttribute
from ..layout.schema import PointSchema
from .base import Metadata, PointReader, PointWriter

__all__ = ["AsciiReader", "AsciiWriter", "AsciiMetadata",
           "schema_from_format", "format_from_schema"]

#: format char -> (attribute, component index | None) — None = whole scalar
_FORMAT_CHARS: Dict[str, Tuple[Optional[PointAttribute], Optional[int]]] = {
    "s": (None, None),
    "x": (att.POSITION_3D, 0),
    "y": (att.POSITION_3D, 1),
    "z": (att.POSITION_3D, 2),
    "i": (att.INTENSITY, None),
    "r": (att.RETURN_NUMBER, None),
    "n": (att.NUMBER_OF_RETURNS, None),
    "c": (att.CLASSIFICATION, None),
    "t": (att.GPS_TIME, None),
    "u": (att.USER_DATA, None),
    "p": (att.POINT_SOURCE_ID, None),
    "R": (att.COLOR_RGB, 0),
    "G": (att.COLOR_RGB, 1),
    "B": (att.COLOR_RGB, 2),
    "I": (att.NIR, None),
    "a": (att.SCAN_ANGLE_RANK, None),
    "e": (att.EDGE_OF_FLIGHT_LINE, None),
    "d": (att.SCAN_DIRECTION_FLAG, None),
}


def _parse_format(fmt: str):
    out = []
    for ch in fmt:
        if ch not in _FORMAT_CHARS:
            raise ValueError(
                f"FormatError can't interpret format literal {ch!r} in "
                f"format string {fmt!r}.")
        out.append((ch,) + _FORMAT_CHARS[ch])
    return out


def schema_from_format(fmt: str) -> PointSchema:
    """PointSchema for a format string (attribute appears once even when
    multiple literals feed it, e.g. xyz -> one POSITION_3D)."""
    schema = PointSchema()
    for _, attr, _c in _parse_format(fmt):
        if attr is not None and not schema.has_attribute_with_name(attr.name):
            schema.add_attribute(attr)
    return schema


_VECTOR_LITERALS = {att.POSITION_3D.name: "xyz", att.COLOR_RGB.name: "RGB"}
_SCALAR_LITERALS = {a.name: ch for ch, (a, comp) in _FORMAT_CHARS.items()
                    if a is not None and comp is None}


def format_from_schema(schema: PointSchema) -> str:
    """Best-effort inverse of :func:`schema_from_format`."""
    out = []
    for m in schema.members:
        if m.name in _VECTOR_LITERALS:
            out.append(_VECTOR_LITERALS[m.name])
        elif m.name in _SCALAR_LITERALS:
            out.append(_SCALAR_LITERALS[m.name])
        else:
            raise ValueError(
                f"attribute {m.name!r} has no ASCII format literal")
    return "".join(out)


class AsciiMetadata(Metadata):
    """Stub metadata — ASCII knows neither bounds nor point count
    (reference ascii_metadata.rs:7)."""

    def bounds(self):
        return None

    def number_of_points(self):
        return None

    def get_named_field(self, name: str):
        return None


class AsciiReader(PointReader):
    """Format-string driven text reader (reference ascii_reader.rs /
    raw_reader.rs)."""

    def __init__(self, source: Union[str, Path, _io.IOBase], format: str,
                 delimiter: str = ", ") -> None:
        if isinstance(source, (str, Path)):
            self._stream = open(source, "r")
            self._owns = True
        else:
            self._stream = source
            self._owns = False
        self._entries = _parse_format(format)
        self._schema = schema_from_format(format)
        self._delimiter = delimiter
        self._metadata = AsciiMetadata()

    def get_metadata(self) -> AsciiMetadata:
        return self._metadata

    def get_default_point_schema(self) -> PointSchema:
        return self._schema

    def _parse_line(self, line: str, line_no: int,
                    cols: Dict[str, np.ndarray], row: int) -> None:
        parts = line.split(self._delimiter)
        if len(parts) < len(self._entries):
            raise ValueError(
                "Input format string expected more items in the line "
                f"(line {line_no}: {len(parts)} < {len(self._entries)})")
        for (ch, attr, comp), tok in zip(self._entries, parts):
            if attr is None:
                continue
            tok = tok.strip()
            m = self._schema.member(attr.name)
            try:
                if m.dtype.kind == "float":
                    val = float(tok)
                else:
                    val = int(tok)
            except ValueError:
                raise ValueError(
                    f"ParseError at parsing {attr.name} for format literal "
                    f"{ch!r} on line {line_no}: {tok!r}") from None
            # flag literals are booleans in the reference (raw_reader.rs:155+)
            if ch in ("e", "d") and val not in (0, 1):
                raise ValueError(f"ParseError expected bool found {tok!r} "
                                 f"on line {line_no}")
            if comp is None:
                cols[attr.name][row] = val
            else:
                cols[attr.name][row, comp] = val

    def read(self, count: int, schema: Optional[PointSchema] = None
             ) -> HostPointBuffer:
        lines: List[str] = []
        for _ in range(count):
            line = self._stream.readline()
            if not line:
                break
            if line.strip():
                lines.append(line)
        n = len(lines)
        cols = {
            m.name: np.zeros((n,) + m.dtype.np_shape,
                             m.dtype.np_component_dtype)
            for m in self._schema.members
        }
        for row, line in enumerate(lines):
            self._parse_line(line, row + 1, cols, row)
        buf = HostPointBuffer(self._schema, cols, validate=False)
        if schema is not None and schema != self._schema:
            return buf.convert_schema(schema, fill_missing_with_default=True)
        return buf

    def read_all(self, schema: Optional[PointSchema] = None
                 ) -> HostPointBuffer:
        return self.read(2 ** 62, schema)

    def close(self) -> None:
        if self._owns:
            self._stream.close()


def _trim_zeros(s: str) -> str:
    """Trailing-zero trimming like the reference's
    trim_unnecessary_tailing_zeros: keep at least one decimal digit."""
    if "." not in s:
        return s
    s = s.rstrip("0")
    if s.endswith("."):
        s += "0"
    return s


class AsciiWriter(PointWriter):
    """Format-string driven text writer (reference ascii_writer.rs /
    raw_writer.rs)."""

    def __init__(self, target: Union[str, Path, _io.IOBase],
                 schema_or_format: Union[PointSchema, str],
                 format: Optional[str] = None,
                 delimiter: str = ", ", precision: int = 5) -> None:
        if isinstance(schema_or_format, str) and format is None:
            format = schema_or_format
            schema_or_format = schema_from_format(format)
        elif format is None:
            format = format_from_schema(schema_or_format)
        if isinstance(target, (str, Path)):
            self._stream = open(target, "w")
            self._owns = True
        else:
            self._stream = target
            self._owns = False
        self._entries = _parse_format(format)
        self._schema = (schema_or_format
                        if isinstance(schema_or_format, PointSchema)
                        else schema_from_format(format))
        self.delimiter = delimiter
        self.precision = precision

    def set_delimiter(self, delimiter: str) -> None:
        self.delimiter = delimiter

    def set_precision(self, precision: int) -> None:
        self.precision = precision

    def get_default_point_schema(self) -> PointSchema:
        return self._schema

    def write(self, buffer: HostPointBuffer) -> None:
        # pull each referenced column, converting dtypes where needed
        cols = {}
        for _, attr, _c in self._entries:
            if attr is None or attr.name in cols:
                continue
            if buffer.schema.has_attribute_with_name(attr.name):
                cols[attr.name] = buffer.get_converted(attr)
            else:
                cols[attr.name] = np.zeros(
                    (len(buffer),) + attr.dtype.np_shape,
                    attr.dtype.np_component_dtype)
        for row in range(len(buffer)):
            fields = []
            for ch, attr, comp in self._entries:
                if attr is None:
                    fields.append("0")
                    continue
                v = cols[attr.name][row] if comp is None \
                    else cols[attr.name][row, comp]
                if attr.dtype.kind == "float" or \
                        (comp is not None and attr.name == att.POSITION_3D.name):
                    fields.append(_trim_zeros(f"{float(v):.{self.precision}f}"))
                else:
                    fields.append(str(int(v)))
            self._stream.write(self.delimiter.join(fields) + "\n")

    def flush(self) -> None:
        self._stream.flush()

    def close(self) -> None:
        if self._owns:
            self._stream.close()
