"""Grid-based datum transforms for the builtin reprojection engine.

Closes the "grid transforms are proj-backend-only" gap (LIMITATIONS.md;
reference reprojection always delegates to PROJ, reprojection.rs:10-170):

* :class:`Ntv2Grid` — NTv2 ``.gsb`` horizontal datum shift grids
  (Canadian NTv2 binary layout: 11-field overview header, per-subgrid
  headers, 4xf32 nodes in arc-seconds, POSITIVE-WEST longitudes, rows
  south->north and columns east->west).  Bilinear interpolation,
  vectorised over whole columns; the densest (smallest-increment)
  subgrid containing each point wins, matching PROJ's subgrid
  selection.
* :class:`GtxGrid` — ``.gtx`` vertical (geoid undulation) grids:
  ellipsoidal height = orthometric + N(lat, lon).

Both apply in the datum step of the builtin pipeline
(``+nadgrids=…`` / ``+geoidgrids=…`` in proj strings —
algorithms/reprojection.py); inverse shifts use fixed-point iteration
(the fields vary slowly, 4 iterations reach <0.1 mm).  Points outside
every (sub)grid fall back to the CRS's Helmert step (PROJ errors there
instead; the fallback is documented in LIMITATIONS.md).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

__all__ = ["Ntv2Grid", "GtxGrid", "write_ntv2", "write_gtx"]


def _field(buf: bytes, i: int, base: int = 0) -> Tuple[str, bytes]:
    off = base + i * 16
    rec = buf[off:off + 16]
    return rec[:8].decode("ascii", "replace").strip(), rec[8:]


class _SubGrid:
    def __init__(self, s_lat, n_lat, e_lon, w_lon, lat_inc, lon_inc,
                 shifts):
        # NTv2 stores POSITIVE-WEST longitudes; convert limits to the
        # usual positive-east at load (east limit = -E_LONG etc.)
        self.s_lat = s_lat
        self.n_lat = n_lat
        self.w_lon = -w_lon      # positive-east west edge
        self.e_lon = -e_lon      # positive-east east edge
        self.lat_inc = lat_inc
        self.lon_inc = lon_inc
        self.nrow = int(round((n_lat - s_lat) / lat_inc)) + 1
        self.ncol = int(round((w_lon - e_lon) / lon_inc)) + 1
        # shifts[(row, col)] = (lat_shift, lon_shift) arc-seconds,
        # row 0 = south edge, col 0 = EAST edge (positive-west order)
        self.shifts = shifts.reshape(self.nrow, self.ncol, 2)

    def contains(self, lon_deg, lat_deg):
        lat_s = lat_deg * 3600.0
        lon_s = lon_deg * 3600.0
        return ((lat_s >= self.s_lat - 1e-9)
                & (lat_s <= self.n_lat + 1e-9)
                & (lon_s >= self.w_lon - 1e-9)
                & (lon_s <= self.e_lon + 1e-9))

    def sample(self, lon_deg, lat_deg):
        """Bilinear (lat_shift_sec, lon_shift_sec_positive_west)."""
        lat_s = lat_deg * 3600.0
        lon_s = lon_deg * 3600.0
        r = (lat_s - self.s_lat) / self.lat_inc
        # column 0 sits at the EAST edge (the minimum positive-west
        # longitude) and advances westwards, i.e. towards SMALLER
        # positive-east longitudes
        c = (self.e_lon - lon_s) / self.lon_inc
        r0 = np.clip(np.floor(r).astype(np.int64), 0, self.nrow - 2)
        c0 = np.clip(np.floor(c).astype(np.int64), 0, self.ncol - 2)
        fr = np.clip(r - r0, 0.0, 1.0)
        fc = np.clip(c - c0, 0.0, 1.0)
        g = self.shifts
        v00 = g[r0, c0]
        v01 = g[r0, c0 + 1]
        v10 = g[r0 + 1, c0]
        v11 = g[r0 + 1, c0 + 1]
        w00 = ((1 - fr) * (1 - fc))[:, None]
        w01 = ((1 - fr) * fc)[:, None]
        w10 = (fr * (1 - fc))[:, None]
        w11 = (fr * fc)[:, None]
        v = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11
        return v[:, 0], v[:, 1]


class Ntv2Grid:
    """NTv2 ``.gsb`` horizontal shift grid (source datum -> target)."""

    def __init__(self, source: Union[str, Path, bytes]) -> None:
        buf = (Path(source).read_bytes()
               if isinstance(source, (str, Path)) else bytes(source))
        name, v = _field(buf, 0)
        if name != "NUM_OREC":
            raise ValueError("not an NTv2 file (missing NUM_OREC)")
        # official grids ship in both byte orders (PROJ byte-swaps on
        # detection); NUM_OREC == 11 under exactly one interpretation
        endian = None
        for cand in ("<", ">"):
            if struct.unpack(cand + "i", v[:4])[0] == 11:
                endian = cand
                break
        if endian is None:
            raise ValueError(
                f"unsupported NTv2 overview header {v[:4]!r} "
                f"(NUM_OREC != 11 in either byte order)")
        num_srec = struct.unpack(endian + "i", _field(buf, 1)[1][:4])[0]
        num_file = struct.unpack(endian + "i", _field(buf, 2)[1][:4])[0]
        gs_type = _field(buf, 3)[1][:8].decode("ascii").strip()
        if gs_type != "SECONDS":
            raise ValueError(f"unsupported NTv2 GS_TYPE {gs_type!r}")
        off = 11 * 16
        self.subgrids: List[_SubGrid] = []
        for _ in range(num_file):
            hdr = {}
            for i in range(num_srec):
                k, v = _field(buf, i, base=off)
                hdr[k] = v
            off += num_srec * 16
            count = struct.unpack(endian + "i", hdr["GS_COUNT"][:4])[0]
            dbl = lambda k: struct.unpack(endian + "d", hdr[k])[0]  # noqa: E731
            nodes = np.frombuffer(buf, endian + "f4", count * 4, off)
            off += count * 16
            self.subgrids.append(_SubGrid(
                dbl("S_LAT"), dbl("N_LAT"), dbl("E_LONG"), dbl("W_LONG"),
                dbl("LAT_INC"), dbl("LONG_INC"),
                np.ascontiguousarray(
                    nodes.reshape(-1, 4)[:, :2].astype(np.float64))))
        if not self.subgrids:
            raise ValueError("NTv2 file has no subgrids")

    def _select(self, lon, lat):
        """Index of the densest containing subgrid per point (-1 none)."""
        best = np.full(lon.shape, -1, np.int64)
        best_inc = np.full(lon.shape, np.inf)
        for i, g in enumerate(self.subgrids):
            inside = g.contains(lon, lat)
            denser = inside & (g.lat_inc < best_inc)
            best = np.where(denser, i, best)
            best_inc = np.where(denser, g.lat_inc, best_inc)
        return best

    def forward(self, lon: np.ndarray, lat: np.ndarray):
        """source-datum lon/lat (deg) -> shifted lon/lat (deg) +
        ``applied`` mask (False = outside every subgrid, unchanged)."""
        lon = np.asarray(lon, np.float64)
        lat = np.asarray(lat, np.float64)
        sel = self._select(lon, lat)
        out_lon = lon.copy()
        out_lat = lat.copy()
        for i, g in enumerate(self.subgrids):
            m = sel == i
            if not m.any():
                continue
            dlat, dlon_w = g.sample(lon[m], lat[m])
            out_lat[m] = lat[m] + dlat / 3600.0
            # lon shift is stored positive-WEST
            out_lon[m] = lon[m] - dlon_w / 3600.0
        return out_lon, out_lat, sel >= 0

    def inverse(self, lon: np.ndarray, lat: np.ndarray, iters: int = 4):
        """target-datum lon/lat -> source-datum lon/lat (fixed point)."""
        lon = np.asarray(lon, np.float64)
        lat = np.asarray(lat, np.float64)
        src_lon, src_lat = lon.copy(), lat.copy()
        applied = np.zeros(lon.shape, bool)
        for _ in range(iters):
            f_lon, f_lat, applied = self.forward(src_lon, src_lat)
            src_lon = src_lon - (f_lon - lon)
            src_lat = src_lat - (f_lat - lat)
        return src_lon, src_lat, applied


class GtxGrid:
    """``.gtx`` vertical grid: geoid undulation N(lat, lon) in metres.

    Header: 4 f64 (lat0, lon0, dlat, dlon) + 2 i32 (nrows, ncols),
    big-endian; then nrows*ncols f32 values, row-major from the south
    edge.  ``undulation`` returns bilinear N; ellipsoidal = orthometric
    + N."""

    def __init__(self, source: Union[str, Path, bytes]) -> None:
        buf = (Path(source).read_bytes()
               if isinstance(source, (str, Path)) else bytes(source))
        self.lat0, self.lon0, self.dlat, self.dlon = struct.unpack(
            ">dddd", buf[:32])
        self.nrow, self.ncol = struct.unpack(">ii", buf[32:40])
        self.values = np.frombuffer(
            buf, ">f4", self.nrow * self.ncol, 40).astype(
            np.float64).reshape(self.nrow, self.ncol)

    def undulation(self, lon: np.ndarray, lat: np.ndarray) -> np.ndarray:
        lon = np.asarray(lon, np.float64)
        lat = np.asarray(lat, np.float64)
        # grids use [0, 360) or [-180, 180) longitudes; map into the
        # grid's own frame [lon0, lon0 + 360)
        lon = self.lon0 + (lon - self.lon0) % 360.0
        r = (lat - self.lat0) / self.dlat
        c = (lon - self.lon0) / self.dlon
        # no silent extrapolation: edge-clamping a point outside a
        # regional geoid grid would add metres of wrong undulation (PROJ
        # errors there too)
        eps = 1e-9
        bad = ((r < -eps) | (r > self.nrow - 1 + eps)
               | (c < -eps) | (c > self.ncol - 1 + eps))
        if bad.any():
            raise ValueError(
                f"{int(bad.sum())} point(s) outside the geoid grid "
                f"coverage (lat {self.lat0}..{self.lat0 + (self.nrow - 1) * self.dlat}, "
                f"lon {self.lon0}..{self.lon0 + (self.ncol - 1) * self.dlon})")
        r0 = np.clip(np.floor(r).astype(np.int64), 0, self.nrow - 2)
        c0 = np.clip(np.floor(c).astype(np.int64), 0, self.ncol - 2)
        fr = np.clip(r - r0, 0.0, 1.0)
        fc = np.clip(c - c0, 0.0, 1.0)
        g = self.values
        return (g[r0, c0] * (1 - fr) * (1 - fc)
                + g[r0, c0 + 1] * (1 - fr) * fc
                + g[r0 + 1, c0] * fr * (1 - fc)
                + g[r0 + 1, c0 + 1] * fr * fc)


# ---- writers (tests + interop fixtures) ------------------------------------

def write_ntv2(path: Union[str, Path],
               s_lat_deg: float, n_lat_deg: float,
               w_lon_deg: float, e_lon_deg: float,
               lat_inc_sec: float, lon_inc_sec: float,
               lat_shift_sec: np.ndarray,
               lon_shift_west_sec: np.ndarray) -> None:
    """Write a single-subgrid NTv2 ``.gsb`` file (positive-east degree
    limits in, canonical positive-west seconds on disk).  Shift arrays
    are (nrow, ncol) with row 0 = south edge, col 0 = EAST edge."""
    nrow, ncol = lat_shift_sec.shape
    assert lon_shift_west_sec.shape == (nrow, ncol)

    def srec(name: str, payload: bytes) -> bytes:
        return name.encode().ljust(8)[:8] + payload.ljust(8, b"\0")[:8]

    def irec(name, v):
        return srec(name, struct.pack("<i", v))

    def drec(name, v):
        return srec(name, struct.pack("<d", v))

    def crec(name, v):
        return srec(name, v.encode().ljust(8)[:8])

    over = (irec("NUM_OREC", 11) + irec("NUM_SREC", 11)
            + irec("NUM_FILE", 1) + crec("GS_TYPE", "SECONDS")
            + crec("VERSION", "NTv2.0") + crec("SYSTEM_F", "SRC")
            + crec("SYSTEM_T", "DST") + drec("MAJOR_F", 6378137.0)
            + drec("MINOR_F", 6356752.3) + drec("MAJOR_T", 6378137.0)
            + drec("MINOR_T", 6356752.3))
    sub = (crec("SUB_NAME", "SUB0") + crec("PARENT", "NONE")
           + crec("CREATED", "pasture") + crec("UPDATED", "pasture")
           + drec("S_LAT", s_lat_deg * 3600.0)
           + drec("N_LAT", n_lat_deg * 3600.0)
           + drec("E_LONG", -e_lon_deg * 3600.0)
           + drec("W_LONG", -w_lon_deg * 3600.0)
           + drec("LAT_INC", lat_inc_sec) + drec("LONG_INC", lon_inc_sec)
           + irec("GS_COUNT", nrow * ncol))
    nodes = np.zeros((nrow, ncol, 4), "<f4")
    nodes[:, :, 0] = lat_shift_sec
    nodes[:, :, 1] = lon_shift_west_sec
    with open(path, "wb") as f:
        f.write(over)
        f.write(sub)
        f.write(nodes.tobytes())


def write_gtx(path: Union[str, Path], lat0: float, lon0: float,
              dlat: float, dlon: float, values: np.ndarray) -> None:
    """Write a big-endian ``.gtx`` geoid grid (origin ``lat0``/``lon0``
    in degrees, steps ``dlat``/``dlon``, row-major ``values`` in metres)
    — the format :func:`load_gtx` and +geoidgrids consume."""
    nrow, ncol = values.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">dddd", lat0, lon0, dlat, dlon))
        f.write(struct.pack(">ii", nrow, ncol))
        f.write(values.astype(">f4").tobytes())
