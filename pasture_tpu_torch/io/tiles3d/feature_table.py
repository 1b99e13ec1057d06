"""FeatureTable / BatchTable JSON headers with byte-alignment rules.

Parity with pasture's (de)serialization helpers
(reference: pasture-io/src/tiles3d/feature_table.rs:16-210,
batch_table.rs:16-183, common.rs:14-110): JSON headers are padded with
spaces to 8-byte boundaries; values are either inline JSON scalars/arrays or
``{"byteOffset": N}`` references into the binary body.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple, Union

__all__ = [
    "FeatureTableDataReference",
    "read_feature_table_header", "write_feature_table_header",
    "read_batch_table_header", "write_batch_table_header",
    "read_json_header", "write_json_header",
]


@dataclasses.dataclass(frozen=True)
class FeatureTableDataReference:
    """``FeatureTableValue::DataReference`` (feature_table.rs:16-40)."""

    byte_offset: int
    component_type: str = ""


FeatureTableValue = Union[FeatureTableDataReference, int, float, list, dict]


def read_json_header(buf: bytes, offset: int, length: int) -> Dict[str, Any]:
    """Parse a JSON header block, tolerating trailing padding
    (reference common.rs:14-60 / pnts_reader.rs:57-66)."""
    if length == 0:
        return {}
    raw = buf[offset:offset + length]
    text = raw.decode("utf-8", errors="replace").rstrip("\0 \t\r\n")
    if not text:
        return {}
    return json.loads(text)


def write_json_header(obj: Dict[str, Any], align: int = 8,
                      start_offset: int = 0) -> bytes:
    """Serialize + space-pad to ``align`` relative to ``start_offset``
    (reference common.rs:62-110)."""
    raw = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    pad = (-(start_offset + len(raw))) % align
    return raw + b" " * pad


def read_batch_table_header(buf: bytes, offset: int, length: int
                            ) -> Dict[str, FeatureTableValue]:
    """BatchTable JSON header — same wire rules as the FeatureTable
    (reference batch_table.rs:16-183)."""
    return read_feature_table_header(buf, offset, length)


def write_batch_table_header(header: Dict[str, FeatureTableValue],
                             align: int = 8, start_offset: int = 0) -> bytes:
    """Serialise a 3D-Tiles batch-table JSON header (same wire format
    as the feature table; reference tiles3d/mod.rs)."""
    return write_feature_table_header(header, align, start_offset)


def read_feature_table_header(buf: bytes, offset: int, length: int
                              ) -> Dict[str, FeatureTableValue]:
    """Parse a 3D-Tiles feature-table JSON header: scalar/array values
    pass through, ``{"byteOffset": ...}`` objects become
    :class:`FeatureTableDataReference` (reference
    tiles3d/feature_table.rs)."""
    header = read_json_header(buf, offset, length)
    out: Dict[str, FeatureTableValue] = {}
    for key, value in header.items():
        if isinstance(value, dict) and "byteOffset" in value:
            out[key] = FeatureTableDataReference(
                int(value["byteOffset"]), value.get("componentType", ""))
        else:
            out[key] = value
    return out


def write_feature_table_header(header: Dict[str, FeatureTableValue],
                               align: int = 8, start_offset: int = 0) -> bytes:
    """Serialise a 3D-Tiles feature-table JSON header, space-padded to
    ``align`` bytes relative to ``start_offset`` (the pnts body alignment
    rule; reference tiles3d/feature_table.rs)."""
    obj: Dict[str, Any] = {}
    for key, value in header.items():
        if isinstance(value, FeatureTableDataReference):
            ref: Dict[str, Any] = {"byteOffset": value.byte_offset}
            if value.component_type:
                ref["componentType"] = value.component_type
            obj[key] = ref
        else:
            obj[key] = value
    return write_json_header(obj, align, start_offset)
