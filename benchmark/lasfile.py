"""A NumPy writer of LAS 1.4 files with point data record format 6.

The benchmark writes its survey tiles itself, so that what the program
reads is made by code outside the program.  Format 6 is the 30-byte record
of LAS 1.4 (ASPRS LAS Specification 1.4 R15, tables 3 and 16): X, Y, Z as
int32 locals, intensity, return byte, flags byte, classification, user
data, scan angle, point source ID and GPS time.  No VLRs follow the
375-byte header.
"""

from __future__ import annotations

import struct

import numpy as np

RECORD = np.dtype([("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"),
                   ("intensity", "<u2"), ("returns", "u1"), ("flags", "u1"),
                   ("classification", "u1"), ("user_data", "u1"),
                   ("scan_angle", "<i2"), ("point_source_id", "<u2"),
                   ("gps_time", "<f8")])
HEADER_SIZE = 375
assert RECORD.itemsize == 30


def header_bytes(n: int, scale, offset, mins, maxs) -> bytes:
    """The 375-byte LAS 1.4 header of ``n`` format-6 records."""
    base = struct.pack(
        "<4sHH16sBB32s32sHHHIIBHI5I3d3d6d",
        b"LASF", 0, 0x10,           # global encoding: CRS given as WKT
        b"\0" * 16, 1, 4,
        b"benchmark".ljust(32, b"\0"), b"benchmark lasfile".ljust(32, b"\0"),
        1, 2024, HEADER_SIZE, HEADER_SIZE, 0,
        6, RECORD.itemsize, 0, 0, 0, 0, 0, 0,
        *scale, *offset,
        maxs[0], mins[0], maxs[1], mins[1], maxs[2], mins[2])
    tail = struct.pack("<QQIQ15Q", 0, 0, 0, n, n, *([0] * 14))
    out = base + tail
    assert len(out) == HEADER_SIZE, len(out)
    return out


def write_las(path, local: np.ndarray, intensity: np.ndarray,
              classification: np.ndarray, scale=(0.001, 0.001, 0.001),
              offset=(0.0, 0.0, 0.0)) -> None:
    """Write ``local`` (n, 3) int32 coordinates with their intensity and
    classification as one format-6 file; every point is the first of one
    return, GPS times increase by a microsecond a point.  The header's
    bounds are ``local * scale + offset`` in float64, as the specification
    asks."""
    n = local.shape[0]
    scale = np.asarray(scale, np.float64)
    offset = np.asarray(offset, np.float64)
    mins = local.min(axis=0).astype(np.float64) * scale + offset
    maxs = local.max(axis=0).astype(np.float64) * scale + offset
    rec = np.zeros(n, RECORD)
    rec["X"], rec["Y"], rec["Z"] = local[:, 0], local[:, 1], local[:, 2]
    rec["intensity"] = intensity
    rec["returns"] = 0x11
    rec["classification"] = classification
    rec["gps_time"] = np.arange(n, dtype=np.float64) * 1e-6
    with open(path, "wb") as f:
        f.write(header_bytes(n, scale, offset, mins, maxs))
        rec.tofile(f)
