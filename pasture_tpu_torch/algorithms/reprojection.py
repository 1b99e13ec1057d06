"""CRS reprojection (parity: pasture-algorithms/src/reprojection.rs:10-170).

Port of pasture_tpu/algorithms/reprojection.py: the same host f64 engine.

The reference binds the C PROJ library via ``proj-sys`` FFI and transforms
one point per call.  This build has two backends:

* **proj** — a ctypes binding to the system ``libproj``
  (:mod:`pasture_tpu_torch.native.proj`): arbitrary CRS pairs (EPSG codes, WKT,
  pipelines), whole columns per FFI call.  Full reference parity.
* **builtin** — a self-contained, vectorised f64 geodesy engine used when
  ``libproj`` is absent.  Supported methods (EPSG Guidance Note 7-2 formulas):

  - geographic        ``longlat``  (lon, lat, h in degrees/m)
  - geocentric        ``geocent``  (ECEF)
  - web mercator      ``webmerc``  (spherical)
  - (universal) transverse mercator ``utm`` / ``tmerc`` —
    Karney/Krüger series, 4th order in n (sub-mm over UTM extents)
  - Lambert conformal conic ``lcc`` (1SP and 2SP)
  - oblique stereographic ``sterea`` (double projection, EPSG 9809)
  - polar stereographic ``stere`` (variants A/B, EPSG 9810/9829)
  - Lambert azimuthal equal area ``laea`` (EPSG 9820)
  - Albers equal area ``aea`` (EPSG 9822)

  on parameterised ellipsoids (WGS84, GRS80, international, Bessel, Airy,
  Clarke 1866, Krassowsky), with 3/7-parameter Helmert datum shifts
  (position-vector convention, the ``+towgs84`` contract) between datums.

Both backends use GIS axis order (x=lon/east, y=lat/north, z=up) for every
CRS regardless of the EPSG axis convention.  A curated EPSG table covers
common national grids; any other code needs the proj backend.  Golden
values for the builtin engine are PROJ-generated fixtures
(tests/golden/reprojection_golden.json, <1 mm agreement).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..buffers.device import PointBatch
from ..buffers.host import HostPointBuffer
from ..layout import attributes as att
from ..math.aabb import AABB

__all__ = ["Projection", "reproject_point_cloud_within",
           "reproject_point_cloud_between", "Ellipsoid", "ELLIPSOIDS"]


# =============================================================== ellipsoids

@dataclass(frozen=True)
class Ellipsoid:
    """Reference ellipsoid: semi-major axis + inverse flattening."""

    name: str
    a: float
    inv_f: float

    @property
    def f(self) -> float:
        return 1.0 / self.inv_f

    @property
    def b(self) -> float:
        return self.a * (1.0 - self.f)

    @property
    def e2(self) -> float:
        return self.f * (2.0 - self.f)

    @property
    def e(self) -> float:
        return math.sqrt(self.e2)

    @property
    def n3(self) -> float:
        """Third flattening n = f / (2 - f)."""
        return self.f / (2.0 - self.f)

    # Krüger series coefficients for the transverse mercator (4th order
    # in the third flattening n — sub-mm within UTM zone extents).
    def kruger(self):
        n = self.n3
        a_bar = self.a / (1 + n) * (1 + n**2 / 4 + n**4 / 64)
        alpha = (
            n / 2 - 2 * n**2 / 3 + 5 * n**3 / 16 + 41 * n**4 / 180,
            13 * n**2 / 48 - 3 * n**3 / 5 + 557 * n**4 / 1440,
            61 * n**3 / 240 - 103 * n**4 / 140,
            49561 * n**4 / 161280,
        )
        beta = (
            n / 2 - 2 * n**2 / 3 + 37 * n**3 / 96 - n**4 / 360,
            n**2 / 48 + n**3 / 15 - 437 * n**4 / 1440,
            17 * n**3 / 480 - 37 * n**4 / 840,
            4397 * n**4 / 161280,
        )
        # conformal -> geodetic latitude to n**4, as alpha and beta: the
        # series cut at n**3 is up to 0.7 mm off in latitude
        delta = (
            2 * n - 2 * n**2 / 3 - 2 * n**3 + 116 * n**4 / 45,
            7 * n**2 / 3 - 8 * n**3 / 5 - 227 * n**4 / 45,
            56 * n**3 / 15 - 136 * n**4 / 35,
            4279 * n**4 / 630,
        )
        return a_bar, alpha, beta, delta


ELLIPSOIDS: Dict[str, Ellipsoid] = {
    "WGS84": Ellipsoid("WGS84", 6378137.0, 298.257223563),
    "GRS80": Ellipsoid("GRS80", 6378137.0, 298.257222101),
    "intl": Ellipsoid("intl", 6378388.0, 297.0),
    "bessel": Ellipsoid("bessel", 6377397.155, 299.1528128),
    "airy": Ellipsoid("airy", 6377563.396, 299.3249646),
    "clrk66": Ellipsoid("clrk66", 6378206.4, 294.9786982138982),
    "krass": Ellipsoid("krass", 6378245.0, 298.3),
}
_WGS84 = ELLIPSOIDS["WGS84"]


# ======================================================= common ellipsoidal

def _iso_t(phi, e):
    """EPSG t(φ) = tan(π/4 − φ/2) / [(1 − e sinφ)/(1 + e sinφ)]^(e/2)."""
    s = np.sin(phi)
    return np.tan(np.pi / 4 - phi / 2) / ((1 - e * s) / (1 + e * s)) ** (e / 2)


def _phi_from_t(t, e, iters=8):
    """Invert t(φ) by fixed-point iteration (GN7-2 convergence < 1e-12)."""
    phi = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(iters):
        s = np.sin(phi)
        phi = np.pi / 2 - 2 * np.arctan(
            t * ((1 - e * s) / (1 + e * s)) ** (e / 2))
    return phi


def _m_par(phi, e2):
    """EPSG m(φ) = cosφ / sqrt(1 − e² sin²φ)."""
    return np.cos(phi) / np.sqrt(1 - e2 * np.sin(phi) ** 2)


def _q_auth(phi, e):
    """EPSG authalic q(φ) (LAEA/Albers)."""
    s = np.sin(phi)
    e2 = e * e
    return (1 - e2) * (s / (1 - e2 * s * s)
                       - (1 / (2 * e)) * np.log((1 - e * s) / (1 + e * s)))


def _phi_from_q(q, e, c1, c2, c3):
    """Invert q(φ): authalic-latitude series seed + Newton polish.

    The 3-term series alone truncates at ~1e-8 rad; two Newton steps on
    q(φ) − q = 0 (dq/dφ = 2(1−e²)cosφ/(1−e²sin²φ)²) bring the inverse to
    f64 round-off so projected→geographic→projected round-trips close.
    """
    qp = float(_q_auth(np.asarray(np.pi / 2), e))
    beta = np.arcsin(np.clip(q / qp, -1.0, 1.0))
    phi = beta + c1 * np.sin(2 * beta) + c2 * np.sin(4 * beta) \
        + c3 * np.sin(6 * beta)
    e2 = e * e
    for _ in range(2):
        s = np.sin(phi)
        dq = 2 * (1 - e2) * np.cos(phi) / (1 - e2 * s * s) ** 2
        dq = np.where(np.abs(dq) < 1e-300, 1.0, dq)  # poles: cosφ -> 0
        phi = phi - (_q_auth(phi, e) - q) / dq
    return phi


# ============================================================== projections

class _Proj:
    """Base: forward(lon°, lat°) -> (x, y); inverse(x, y) -> (lon°, lat°)."""

    def forward(self, lon, lat):
        raise NotImplementedError

    def inverse(self, x, y):
        raise NotImplementedError


class _LonLat(_Proj):
    def __init__(self, ell):
        self.ell = ell

    def forward(self, lon, lat):
        return lon, lat

    def inverse(self, x, y):
        return x, y


class _WebMercator(_Proj):
    """Spherical mercator on the ellipsoid's semi-major (EPSG 1024)."""

    def __init__(self, ell):
        self.a = ell.a

    def forward(self, lon, lat):
        x = self.a * np.radians(lon)
        y = self.a * np.log(np.tan(np.pi / 4 + np.radians(lat) / 2))
        return x, y

    def inverse(self, x, y):
        lon = np.degrees(x / self.a)
        lat = np.degrees(2 * np.arctan(np.exp(y / self.a)) - np.pi / 2)
        return lon, lat


class _TransverseMercator(_Proj):
    """Krüger series TM with lat_0/k_0/FE/FN (covers utm + tmerc)."""

    def __init__(self, ell, lon0, lat0=0.0, k0=0.9996, fe=500000.0, fn=0.0):
        self.ell, self.lon0, self.k0, self.fe = ell, lon0, k0, fe
        self.a_bar, self.alpha, self.beta, self.delta = ell.kruger()
        # northing of the natural origin: k0 * meridian arc at (lon0, lat0)
        if lat0 != 0.0:
            xi0 = self._xi_eta(np.asarray([lon0]), np.asarray([lat0]))[0][0]
            self.fn = fn - k0 * self.a_bar * float(xi0)
        else:
            self.fn = fn

    def _xi_eta(self, lon, lat):
        e = self.ell.e
        lam = np.radians(lon - self.lon0)
        phi = np.radians(lat)
        s = np.sin(phi)
        t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
        xi = np.arctan2(t, np.cos(lam))
        eta = np.arcsinh(np.sin(lam) / np.sqrt(t * t + np.cos(lam) ** 2))
        xs, es = xi.copy(), eta.copy()
        for j, a in enumerate(self.alpha, start=1):
            xs = xs + a * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
            es = es + a * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
        return xs, es

    def forward(self, lon, lat):
        xs, es = self._xi_eta(np.asarray(lon, np.float64),
                              np.asarray(lat, np.float64))
        return (self.fe + self.k0 * self.a_bar * es,
                self.fn + self.k0 * self.a_bar * xs)

    def inverse(self, x, y):
        xi = (y - self.fn) / (self.k0 * self.a_bar)
        eta = (x - self.fe) / (self.k0 * self.a_bar)
        xs, es = np.asarray(xi, np.float64).copy(), \
            np.asarray(eta, np.float64).copy()
        for j, b in enumerate(self.beta, start=1):
            xs = xs - b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
            es = es - b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
        chi = np.arcsin(np.sin(xs) / np.cosh(es))
        phi = chi.copy()
        for j, d in enumerate(self.delta, start=1):
            phi = phi + d * np.sin(2 * j * chi)
        lam = np.arctan2(np.sinh(es), np.cos(xs))
        return np.degrees(lam) + self.lon0, np.degrees(phi)


class _LambertConformalConic(_Proj):
    """LCC 2SP (EPSG 9802) / 1SP (9801: lat_1 == lat_2 == lat_0, k_0)."""

    def __init__(self, ell, lon0, lat0, lat1, lat2=None, k0=1.0,
                 fe=0.0, fn=0.0):
        self.ell, self.lon0, self.fe, self.fn = ell, lon0, fe, fn
        e, e2, a = ell.e, ell.e2, ell.a
        p0, p1 = np.radians(lat0), np.radians(lat1)
        t0, t1 = _iso_t(p0, e), _iso_t(p1, e)
        m1 = _m_par(p1, e2)
        if lat2 is not None and abs(lat2 - lat1) > 1e-12:
            p2 = np.radians(lat2)
            t2, m2 = _iso_t(p2, e), _m_par(p2, e2)
            self.n = (np.log(m1) - np.log(m2)) / (np.log(t1) - np.log(t2))
        else:
            self.n = np.sin(p1)
        self.F = m1 / (self.n * t1 ** self.n) * k0
        # r at the false origin latitude; t0 == 0 at the pole => r0 == 0
        self.r0 = a * self.F * t0 ** self.n if t0 > 0 else 0.0
        self.a = a

    def forward(self, lon, lat):
        e = self.ell.e
        t = _iso_t(np.radians(np.asarray(lat, np.float64)), e)
        r = self.a * self.F * np.where(t > 0, t, 0.0) ** self.n
        th = self.n * np.radians(np.asarray(lon, np.float64) - self.lon0)
        return self.fe + r * np.sin(th), self.fn + self.r0 - r * np.cos(th)

    def inverse(self, x, y):
        e = self.ell.e
        dx = np.asarray(x, np.float64) - self.fe
        dy = self.r0 - (np.asarray(y, np.float64) - self.fn)
        r = np.sign(self.n) * np.hypot(dx, dy)
        t = (r / (self.a * self.F)) ** (1.0 / self.n)
        th = np.arctan2(np.sign(self.n) * dx, np.sign(self.n) * dy)
        lon = np.degrees(th / self.n) + self.lon0
        lat = np.degrees(_phi_from_t(t, e))
        return lon, lat


class _ObliqueStereographic(_Proj):
    """EPSG 9809 (double projection via the conformal sphere) — RD New."""

    def __init__(self, ell, lon0, lat0, k0=1.0, fe=0.0, fn=0.0):
        self.ell, self.lon0d, self.k0, self.fe, self.fn = \
            ell, lon0, k0, fe, fn
        e, e2, a = ell.e, ell.e2, ell.a
        p0 = math.radians(lat0)
        s0 = math.sin(p0)
        rho0 = a * (1 - e2) / (1 - e2 * s0 * s0) ** 1.5
        nu0 = a / math.sqrt(1 - e2 * s0 * s0)
        self.R = math.sqrt(rho0 * nu0)
        self.nc = math.sqrt(1 + e2 * math.cos(p0) ** 4 / (1 - e2))
        S1 = (1 + s0) / (1 - s0)
        S2 = (1 - e * s0) / (1 + e * s0)
        w1 = (S1 * S2 ** e) ** self.nc
        sin_chi0 = (w1 - 1) / (w1 + 1)
        self.c = ((self.nc + s0) * (1 - sin_chi0)
                  / ((self.nc - s0) * (1 + sin_chi0)))
        w2 = self.c * w1
        self.chi0 = math.asin((w2 - 1) / (w2 + 1))
        self.lam0 = math.radians(lon0)

    def _conformal(self, lon, lat):
        e = self.ell.e
        phi = np.radians(np.asarray(lat, np.float64))
        lam = (self.nc * (np.radians(np.asarray(lon, np.float64))
                          - self.lam0) + self.lam0)
        s = np.sin(phi)
        Sa = (1 + s) / (1 - s)
        Sb = (1 - e * s) / (1 + e * s)
        w = self.c * (Sa * Sb ** e) ** self.nc
        chi = np.arcsin((w - 1) / (w + 1))
        return lam, chi

    def forward(self, lon, lat):
        lam, chi = self._conformal(lon, lat)
        dl = lam - self.lam0
        B = (1 + np.sin(chi) * math.sin(self.chi0)
             + np.cos(chi) * math.cos(self.chi0) * np.cos(dl))
        x = self.fe + 2 * self.R * self.k0 * np.cos(chi) * np.sin(dl) / B
        y = self.fn + 2 * self.R * self.k0 * (
            np.sin(chi) * math.cos(self.chi0)
            - np.cos(chi) * math.sin(self.chi0) * np.cos(dl)) / B
        return x, y

    def inverse(self, x, y):
        e = self.ell.e
        g = 2 * self.R * self.k0 * math.tan(np.pi / 4 - self.chi0 / 2)
        h = 4 * self.R * self.k0 * math.tan(self.chi0) + g
        dx = np.asarray(x, np.float64) - self.fe
        dy = np.asarray(y, np.float64) - self.fn
        i = np.arctan2(dx, h + dy)
        j = np.arctan2(dx, g - dy) - i
        chi = self.chi0 + 2 * np.arctan2(dy - dx * np.tan(j / 2),
                                         2 * self.R * self.k0)
        lam = j + 2 * i + self.lam0
        lon = np.degrees((lam - self.lam0) / self.nc) + self.lon0d
        # isometric latitude of chi, then invert to geodetic phi
        psi = 0.5 * np.log((1 + np.sin(chi)) / (self.c * (1 - np.sin(chi)))) \
            / self.nc
        phi = 2 * np.arctan(np.exp(psi)) - np.pi / 2
        for _ in range(6):
            s = np.sin(phi)
            psi_i = np.log(np.tan(phi / 2 + np.pi / 4)
                           * ((1 - e * s) / (1 + e * s)) ** (e / 2))
            phi = phi - (psi_i - psi) * np.cos(phi) * (1 - e * e * s * s) \
                / (1 - e * e)
        return lon, np.degrees(phi)


class _PolarStereographic(_Proj):
    """EPSG 9810 (variant A: k0 at the pole) / 9829 (variant B: lat_ts)."""

    def __init__(self, ell, lon0, north=True, k0=None, lat_ts=None,
                 fe=0.0, fn=0.0):
        self.ell, self.lon0, self.north, self.fe, self.fn = \
            ell, lon0, north, fe, fn
        e = ell.e
        if k0 is None:
            if lat_ts is None:
                k0 = 1.0
            else:
                pf = math.radians(abs(lat_ts))
                tf = _iso_t(np.asarray(pf), e)
                mf = _m_par(np.asarray(pf), ell.e2)
                k0 = float(mf * math.sqrt((1 + e) ** (1 + e)
                                          * (1 - e) ** (1 - e)) / (2 * tf))
        self.k0 = k0

    def forward(self, lon, lat):
        e, a = self.ell.e, self.ell.a
        lat = np.asarray(lat, np.float64)
        lon = np.asarray(lon, np.float64)
        sgn = 1.0 if self.north else -1.0
        t = _iso_t(np.radians(sgn * lat), e)
        rho = 2 * a * self.k0 * t / math.sqrt((1 + e) ** (1 + e)
                                              * (1 - e) ** (1 - e))
        # EPSG 9810: E = FE + rho·sin(λ−λ0) in BOTH aspects; only the
        # northing term flips sign between the poles.
        th = np.radians(lon - self.lon0)
        return (self.fe + rho * np.sin(th),
                self.fn - sgn * rho * np.cos(th))

    def inverse(self, x, y):
        e, a = self.ell.e, self.ell.a
        sgn = 1.0 if self.north else -1.0
        dx = np.asarray(x, np.float64) - self.fe
        dy = (np.asarray(y, np.float64) - self.fn) * (-sgn)
        rho = np.hypot(dx, dy)
        t = rho * math.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e)) \
            / (2 * a * self.k0)
        phi = _phi_from_t(t, e)
        lon = self.lon0 + np.degrees(np.arctan2(dx, dy))
        return lon, sgn * np.degrees(phi)


class _LambertAzimuthalEqualArea(_Proj):
    """EPSG 9820 (oblique aspect) — e.g. ETRS89-LAEA Europe."""

    def __init__(self, ell, lon0, lat0, fe=0.0, fn=0.0):
        self.ell, self.lon0, self.fe, self.fn = ell, lon0, fe, fn
        e, e2, a = ell.e, ell.e2, ell.a
        self.qp = float(_q_auth(np.asarray(np.pi / 2), e))
        p0 = math.radians(lat0)
        q0 = float(_q_auth(np.asarray(p0), e))
        self.beta0 = math.asin(q0 / self.qp)
        self.Rq = a * math.sqrt(self.qp / 2)
        m0 = float(_m_par(np.asarray(p0), e2))
        self.D = a * m0 / (self.Rq * math.cos(self.beta0))
        # authalic -> geodetic series coefficients
        self.c1 = e2 / 3 + 31 * e2**2 / 180 + 517 * e2**3 / 5040
        self.c2 = 23 * e2**2 / 360 + 251 * e2**3 / 3780
        self.c3 = 761 * e2**3 / 45360

    def forward(self, lon, lat):
        e = self.ell.e
        q = _q_auth(np.radians(np.asarray(lat, np.float64)), e)
        beta = np.arcsin(np.clip(q / self.qp, -1, 1))
        dl = np.radians(np.asarray(lon, np.float64) - self.lon0)
        B = self.Rq * np.sqrt(
            2 / (1 + math.sin(self.beta0) * np.sin(beta)
                 + math.cos(self.beta0) * np.cos(beta) * np.cos(dl)))
        x = self.fe + B * self.D * np.cos(beta) * np.sin(dl)
        y = self.fn + (B / self.D) * (
            math.cos(self.beta0) * np.sin(beta)
            - math.sin(self.beta0) * np.cos(beta) * np.cos(dl))
        return x, y

    def inverse(self, x, y):
        dx = (np.asarray(x, np.float64) - self.fe) / self.D
        dy = (np.asarray(y, np.float64) - self.fn) * self.D
        rho = np.hypot(dx, dy)
        C = 2 * np.arcsin(np.clip(rho / (2 * self.Rq), -1, 1))
        rho = np.where(rho == 0, 1.0, rho)  # guard: centre point
        beta = np.arcsin(np.clip(
            np.cos(C) * math.sin(self.beta0)
            + dy * np.sin(C) * math.cos(self.beta0) / rho, -1, 1))
        lam = np.arctan2(dx * np.sin(C),
                         rho * math.cos(self.beta0) * np.cos(C)
                         - dy * math.sin(self.beta0) * np.sin(C))
        q = np.sin(beta) * self.qp
        phi = _phi_from_q(q, self.ell.e, self.c1, self.c2, self.c3)
        return self.lon0 + np.degrees(lam), np.degrees(phi)


class _AlbersEqualArea(_Proj):
    """EPSG 9822 — e.g. NAD83 / Conus Albers."""

    def __init__(self, ell, lon0, lat0, lat1, lat2, fe=0.0, fn=0.0):
        self.ell, self.lon0, self.fe, self.fn = ell, lon0, fe, fn
        e, e2, a = ell.e, ell.e2, ell.a
        p0, p1, p2 = (math.radians(v) for v in (lat0, lat1, lat2))
        m1 = float(_m_par(np.asarray(p1), e2))
        m2 = float(_m_par(np.asarray(p2), e2))
        q0 = float(_q_auth(np.asarray(p0), e))
        q1 = float(_q_auth(np.asarray(p1), e))
        q2 = float(_q_auth(np.asarray(p2), e))
        self.n = (m1 * m1 - m2 * m2) / (q2 - q1)
        self.C = m1 * m1 + self.n * q1
        self.rho0 = a * math.sqrt(self.C - self.n * q0) / self.n
        self.a = a
        e2_ = e2
        self.c1 = e2_ / 3 + 31 * e2_**2 / 180 + 517 * e2_**3 / 5040
        self.c2 = 23 * e2_**2 / 360 + 251 * e2_**3 / 3780
        self.c3 = 761 * e2_**3 / 45360

    def forward(self, lon, lat):
        e = self.ell.e
        q = _q_auth(np.radians(np.asarray(lat, np.float64)), e)
        rho = self.a * np.sqrt(np.maximum(self.C - self.n * q, 0)) / self.n
        th = self.n * np.radians(np.asarray(lon, np.float64) - self.lon0)
        return (self.fe + rho * np.sin(th),
                self.fn + self.rho0 - rho * np.cos(th))

    def inverse(self, x, y):
        dx = np.asarray(x, np.float64) - self.fe
        dy = self.rho0 - (np.asarray(y, np.float64) - self.fn)
        rho = np.hypot(dx, dy) * np.sign(self.n)
        th = np.arctan2(np.sign(self.n) * dx, np.sign(self.n) * dy)
        q = (self.C - (rho * self.n / self.a) ** 2) / self.n
        phi = _phi_from_q(q, self.ell.e, self.c1, self.c2, self.c3)
        return self.lon0 + np.degrees(th / self.n), np.degrees(phi)


# ============================================================ datum shifts

def _geodetic_to_ecef(lon, lat, h, ell):
    phi, lam = np.radians(lat), np.radians(lon)
    n = ell.a / np.sqrt(1 - ell.e2 * np.sin(phi) ** 2)
    x = (n + h) * np.cos(phi) * np.cos(lam)
    y = (n + h) * np.cos(phi) * np.sin(lam)
    z = (n * (1 - ell.e2) + h) * np.sin(phi)
    return x, y, z


def _ecef_to_geodetic(x, y, z, ell):
    # Bowring's method, iteratively refined
    a, f, e2 = ell.a, ell.f, ell.e2
    lam = np.arctan2(y, x)
    p = np.hypot(x, y)
    b = a * (1 - f)
    e2p = (a**2 - b**2) / b**2
    theta = np.arctan2(z * a, p * b)
    phi = np.arctan2(z + e2p * b * np.sin(theta) ** 3,
                     p - e2 * a * np.cos(theta) ** 3)
    for _ in range(6):
        n = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
        h = p / np.cos(phi) - n
        phi = np.arctan2(z, p * (1 - e2 * n / (n + h)))
    n = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
    h = p / np.cos(phi) - n
    return np.degrees(lam), np.degrees(phi), h


_AS2RAD = math.pi / (180.0 * 3600.0)


def _helmert(xyz: np.ndarray, p: Tuple[float, ...],
             inverse: bool = False) -> np.ndarray:
    """7-parameter Helmert, position-vector convention (the ``+towgs84``
    contract): X' = T + (1 + s·1e-6) · R(rx,ry,rz) · X, rotations in
    arc-seconds, scale in ppm.  3-parameter input = translations only."""
    tx, ty, tz = p[0], p[1], p[2]
    rx = ry = rz = s = 0.0
    if len(p) >= 7:
        rx, ry, rz = (v * _AS2RAD for v in p[3:6])
        s = p[6] * 1e-6
    m = 1.0 + s
    R = np.array([[1.0, -rz, ry],
                  [rz, 1.0, -rx],
                  [-ry, rx, 1.0]])
    T = np.array([tx, ty, tz])
    if not inverse:
        return (m * (xyz @ R.T)) + T
    # exact inverse of the (small-angle) forward
    return ((xyz - T) @ np.linalg.inv(m * R).T)


# ================================================================ CRS model

_UTM_K0 = 0.9996


def _load_grid(spec: str, cls):
    """Resolve a ``+nadgrids=``/``+geoidgrids=`` value: comma-separated
    candidates, ``@``-prefixed entries optional (skipped when missing,
    PROJ semantics); the first loadable grid wins."""
    import os

    last_err = None
    for entry in spec.split(","):
        optional = entry.startswith("@")
        path = entry[1:] if optional else entry
        if not os.path.exists(path):
            if optional:
                continue
            last_err = FileNotFoundError(path)
            continue
        try:
            return cls(path)
        except Exception as e:          # corrupt candidate: try the next
            last_err = e
            continue
    if last_err is not None:
        raise ValueError(f"no loadable datum grid in {spec!r}") \
            from last_err
    return None


class _Crs:
    """Parsed CRS: projection + ellipsoid + optional towgs84 shift."""

    def __init__(self, text: str) -> None:
        self.text = text
        self.towgs84: Optional[Tuple[float, ...]] = None
        self.nadgrids = None     # Ntv2Grid: horizontal datum shift
        self.geoid = None        # GtxGrid: vertical (orthometric) datum
        t = text.strip()
        m = re.fullmatch(r"(?i)epsg:\s*(\d+)", t)
        if m:
            self._from_epsg(int(m.group(1)))
        elif t.startswith("+"):
            self._from_proj_string(t)
        else:
            raise ValueError(f"cannot parse CRS {text!r}")

    # ---- curated EPSG table ------------------------------------------------
    def _from_epsg(self, code: int) -> None:
        e = ELLIPSOIDS
        zero7 = (0.0,) * 7

        def utm(zone, south, ell, shift=None):
            self.kind = "utm"
            self.proj = _TransverseMercator(
                ell, lon0=zone * 6.0 - 183.0, k0=_UTM_K0,
                fe=500000.0, fn=10000000.0 if south else 0.0)
            self.ell, self.towgs84 = ell, shift

        if code in (4326,):
            self.kind, self.proj, self.ell = \
                "longlat", _LonLat(_WGS84), _WGS84
        elif code == 4258:   # ETRS89
            self.kind, self.proj, self.ell, self.towgs84 = \
                "longlat", _LonLat(e["GRS80"]), e["GRS80"], zero7
        elif code == 4269:   # NAD83
            self.kind, self.proj, self.ell, self.towgs84 = \
                "longlat", _LonLat(e["GRS80"]), e["GRS80"], zero7
        elif code == 4978:
            self.kind, self.ell = "geocent", _WGS84
            self.proj = None
        elif code == 3857:
            self.kind, self.proj, self.ell = \
                "webmerc", _WebMercator(_WGS84), _WGS84
        elif 32601 <= code <= 32660:
            utm(code - 32600, False, _WGS84)
        elif 32701 <= code <= 32760:
            utm(code - 32700, True, _WGS84)
        elif 25828 <= code <= 25838:   # ETRS89 / UTM
            utm(code - 25800, False, e["GRS80"], zero7)
        elif 26901 <= code <= 26923:   # NAD83 / UTM
            utm(code - 26900, False, e["GRS80"], zero7)
        elif code == 2154:   # RGF93 / Lambert-93
            self.kind = "lcc"
            self.proj = _LambertConformalConic(
                e["GRS80"], lon0=3.0, lat0=46.5, lat1=49.0, lat2=44.0,
                fe=700000.0, fn=6600000.0)
            self.ell, self.towgs84 = e["GRS80"], zero7
        elif code == 26985:  # NAD83 / Maryland (LCC 2SP)
            self.kind = "lcc"
            self.proj = _LambertConformalConic(
                e["GRS80"], lon0=-77.0, lat0=37.0 + 2.0 / 3.0,
                lat1=39.45, lat2=38.3, fe=400000.0, fn=0.0)
            self.ell, self.towgs84 = e["GRS80"], zero7
        elif code == 31370:  # BD72 / Belgian Lambert 72
            self.kind = "lcc"
            self.proj = _LambertConformalConic(
                e["intl"], lon0=4.367486666666666, lat0=90.0,
                lat1=51.16666723333333, lat2=49.8333339,
                fe=150000.013, fn=5400088.438)
            self.ell = e["intl"]
            self.towgs84 = (-106.8686, 52.2978, -103.7239,
                            0.3366, -0.457, 1.8422, -1.2747)
        elif code == 27700:  # OSGB36 / British National Grid
            self.kind = "tmerc"
            self.proj = _TransverseMercator(
                e["airy"], lon0=-2.0, lat0=49.0, k0=0.9996012717,
                fe=400000.0, fn=-100000.0)
            self.ell = e["airy"]
            self.towgs84 = (446.448, -125.157, 542.06,
                            0.15, 0.247, 0.842, -20.489)
        elif code == 28992:  # Amersfoort / RD New
            self.kind = "sterea"
            self.proj = _ObliqueStereographic(
                e["bessel"], lon0=5.38763888888889,
                lat0=52.15616055555555, k0=0.9999079,
                fe=155000.0, fn=463000.0)
            self.ell = e["bessel"]
            self.towgs84 = (565.417, 50.3319, 465.552,
                            -0.398957, 0.343988, -1.8774, 4.0725)
        elif code == 2193:   # NZGD2000 / NZTM2000
            self.kind = "tmerc"
            self.proj = _TransverseMercator(
                e["GRS80"], lon0=173.0, lat0=0.0, k0=0.9996,
                fe=1600000.0, fn=10000000.0)
            self.ell, self.towgs84 = e["GRS80"], zero7
        elif code == 3035:   # ETRS89-extended / LAEA Europe
            self.kind = "laea"
            self.proj = _LambertAzimuthalEqualArea(
                e["GRS80"], lon0=10.0, lat0=52.0,
                fe=4321000.0, fn=3210000.0)
            self.ell, self.towgs84 = e["GRS80"], zero7
        elif code == 5070:   # NAD83 / Conus Albers
            self.kind = "aea"
            self.proj = _AlbersEqualArea(
                e["GRS80"], lon0=-96.0, lat0=23.0, lat1=29.5, lat2=45.5)
            self.ell, self.towgs84 = e["GRS80"], zero7
        elif code in (32661, 5041):  # WGS84 / UPS North
            self.kind = "stere"
            self.proj = _PolarStereographic(
                _WGS84, lon0=0.0, north=True, k0=0.994,
                fe=2000000.0, fn=2000000.0)
            self.ell = _WGS84
        elif code in (32761, 5042):  # WGS84 / UPS South
            self.kind = "stere"
            self.proj = _PolarStereographic(
                _WGS84, lon0=0.0, north=False, k0=0.994,
                fe=2000000.0, fn=2000000.0)
            self.ell = _WGS84
        elif code == 3413:   # NSIDC Sea Ice Polar Stereographic North
            self.kind = "stere"
            self.proj = _PolarStereographic(
                _WGS84, lon0=-45.0, north=True, lat_ts=70.0)
            self.ell = _WGS84
        elif code == 3031:   # Antarctic Polar Stereographic
            self.kind = "stere"
            self.proj = _PolarStereographic(
                _WGS84, lon0=0.0, north=False, lat_ts=-71.0)
            self.ell = _WGS84
        else:
            raise ValueError(
                f"EPSG:{code} is not in the builtin table (use the proj "
                f"backend for arbitrary codes, or a +proj= string)")

    # ---- +proj string ------------------------------------------------------
    def _from_proj_string(self, t: str) -> None:
        kv: Dict[str, object] = {}
        for tok in t.split():
            if "=" in tok:
                k, v = tok[1:].split("=", 1)
                kv[k] = v
            else:
                kv[tok[1:]] = True
        ell = ELLIPSOIDS.get(str(kv.get("ellps", "WGS84")))
        if ell is None:
            raise ValueError(f"unsupported +ellps={kv.get('ellps')!r}")
        if kv.get("datum") == "WGS84":
            ell = _WGS84
        if "towgs84" in kv:
            self.towgs84 = tuple(float(v)
                                 for v in str(kv["towgs84"]).split(","))
        if "nadgrids" in kv and str(kv["nadgrids"]) != "@null":
            from .datum_grids import Ntv2Grid
            self.nadgrids = _load_grid(str(kv["nadgrids"]), Ntv2Grid)
        if "geoidgrids" in kv:
            from .datum_grids import GtxGrid
            self.geoid = _load_grid(str(kv["geoidgrids"]), GtxGrid)
        self.ell = ell
        f = lambda k, d=0.0: float(kv.get(k, d))  # noqa: E731
        proj = kv.get("proj")
        if proj in ("longlat", "latlong", "lonlat"):
            self.kind, self.proj = "longlat", _LonLat(ell)
        elif proj == "geocent":
            self.kind, self.proj = "geocent", None
        elif proj in ("webmerc", "merc"):
            self.kind, self.proj = "webmerc", _WebMercator(ell)
        elif proj == "utm":
            zone = int(str(kv["zone"]))
            self.kind = "utm"
            self.proj = _TransverseMercator(
                ell, lon0=zone * 6.0 - 183.0, k0=_UTM_K0, fe=500000.0,
                fn=10000000.0 if kv.get("south") else 0.0)
        elif proj == "tmerc":
            self.kind = "tmerc"
            self.proj = _TransverseMercator(
                ell, lon0=f("lon_0"), lat0=f("lat_0"), k0=f("k", f("k_0", 1.0)),
                fe=f("x_0"), fn=f("y_0"))
        elif proj == "lcc":
            lat2 = float(kv["lat_2"]) if "lat_2" in kv else None
            self.kind = "lcc"
            self.proj = _LambertConformalConic(
                ell, lon0=f("lon_0"), lat0=f("lat_0"),
                lat1=f("lat_1", f("lat_0")), lat2=lat2,
                k0=f("k", f("k_0", 1.0)), fe=f("x_0"), fn=f("y_0"))
        elif proj == "sterea":
            self.kind = "sterea"
            self.proj = _ObliqueStereographic(
                ell, lon0=f("lon_0"), lat0=f("lat_0"),
                k0=f("k", f("k_0", 1.0)), fe=f("x_0"), fn=f("y_0"))
        elif proj == "stere":
            lat0 = f("lat_0", 90.0)
            self.kind = "stere"
            self.proj = _PolarStereographic(
                ell, lon0=f("lon_0"), north=lat0 >= 0,
                k0=float(kv["k"]) if "k" in kv else
                (float(kv["k_0"]) if "k_0" in kv else None),
                lat_ts=float(kv["lat_ts"]) if "lat_ts" in kv else None,
                fe=f("x_0"), fn=f("y_0"))
        elif proj == "laea":
            self.kind = "laea"
            self.proj = _LambertAzimuthalEqualArea(
                ell, lon0=f("lon_0"), lat0=f("lat_0"),
                fe=f("x_0"), fn=f("y_0"))
        elif proj == "aea":
            self.kind = "aea"
            self.proj = _AlbersEqualArea(
                ell, lon0=f("lon_0"), lat0=f("lat_0"), lat1=f("lat_1"),
                lat2=f("lat_2"), fe=f("x_0"), fn=f("y_0"))
        else:
            raise ValueError(f"unsupported +proj={proj!r}")

    # ---- geodetic on OWN datum ----------------------------------------------
    def to_geodetic(self, xyz: np.ndarray) -> np.ndarray:
        x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        if self.kind == "geocent":
            lon, lat, h = _ecef_to_geodetic(x, y, z, self.ell)
        elif self.kind == "longlat":
            return xyz
        else:
            lon, lat = self.proj.inverse(x, y)
            h = z
        return np.stack([np.asarray(lon, np.float64),
                         np.asarray(lat, np.float64),
                         np.asarray(h, np.float64)], axis=1)

    def from_geodetic(self, llh: np.ndarray) -> np.ndarray:
        lon, lat, h = llh[:, 0], llh[:, 1], llh[:, 2]
        if self.kind == "geocent":
            x, y, z = _geodetic_to_ecef(lon, lat, h, self.ell)
        elif self.kind == "longlat":
            return llh
        else:
            x, y = self.proj.forward(lon, lat)
            z = h
        return np.stack([np.asarray(x, np.float64),
                         np.asarray(y, np.float64),
                         np.asarray(z, np.float64)], axis=1)

    def _same_datum(self, other: "_Crs") -> bool:
        """True when the src->dst datum step is the EPSG *null* transform.

        PROJ composes e.g. NAD83->WGS84 or RGF93->WGS84 as a geographic
        offset of zero — lon/lat/h pass through numerically even though the
        ellipsoids differ at the 0.1 mm level.  We match that: identical
        shift vectors compose to the identity when they are zero (null
        transform regardless of ellipsoid) or when the ellipsoids match
        (ECEF round-trip is exactly the identity)."""
        if (self.nadgrids is not None or other.nadgrids is not None
                or self.geoid is not None or other.geoid is not None):
            return False
        a = self.towgs84 or (0.0,) * 7
        b = other.towgs84 or (0.0,) * 7
        a = a + (0.0,) * (7 - len(a))
        b = b + (0.0,) * (7 - len(b))
        if any(abs(x - y) >= 1e-12 for x, y in zip(a, b)):
            return False
        return all(abs(x) < 1e-12 for x in a) or \
            self.ell.name == other.ell.name

    def geodetic_to_wgs84(self, llh: np.ndarray) -> np.ndarray:
        """own-datum geodetic -> WGS84 geodetic: NTv2/geoid grids when
        configured (PROJ precedence: grids beat +towgs84), else ECEF +
        Helmert; points outside every subgrid fall back to Helmert."""
        lon, lat, h = llh[:, 0], llh[:, 1], llh[:, 2]
        if self.geoid is not None:
            # orthometric -> ellipsoidal at SOURCE geographic coords
            h = h + self.geoid.undulation(lon, lat)
        if self.nadgrids is not None:
            slon, slat, applied = self.nadgrids.forward(lon, lat)
            out = np.stack([slon, slat, np.asarray(h, np.float64)], axis=1)
            if not applied.all():
                out[~applied] = self._helmert_to_wgs84(
                    np.stack([lon, lat, h], axis=1)[~applied])
            return out
        return self._helmert_to_wgs84(np.stack([lon, lat, h], axis=1))

    def _helmert_to_wgs84(self, llh: np.ndarray) -> np.ndarray:
        x, y, z = _geodetic_to_ecef(llh[:, 0], llh[:, 1], llh[:, 2], self.ell)
        ecef = np.stack([x, y, z], axis=1)
        if self.towgs84 is not None:
            ecef = _helmert(ecef, self.towgs84)
        lon, lat, h = _ecef_to_geodetic(ecef[:, 0], ecef[:, 1], ecef[:, 2],
                                        _WGS84)
        return np.stack([lon, lat, h], axis=1)

    def geodetic_from_wgs84(self, llh: np.ndarray) -> np.ndarray:
        if self.nadgrids is not None or self.geoid is not None:
            lon, lat, h = llh[:, 0], llh[:, 1], llh[:, 2]
            if self.nadgrids is not None:
                slon, slat, applied = self.nadgrids.inverse(lon, lat)
                if not applied.all():
                    fb = self._helmert_from_wgs84(
                        np.stack([lon, lat, h], axis=1)[~applied])
                    slon = np.asarray(slon).copy()
                    slat = np.asarray(slat).copy()
                    h = np.asarray(h, np.float64).copy()
                    slon[~applied] = fb[:, 0]
                    slat[~applied] = fb[:, 1]
                    # mirror the forward fallback, which applies the FULL
                    # 3-D Helmert (height included) outside every subgrid —
                    # keeping the WGS84 height here would break
                    # forward/inverse round-trips whenever the push/pop-v3
                    # height restore is skipped (geoid or geocentric ends)
                    h[~applied] = fb[:, 2]
                lon, lat = slon, slat
            else:
                # geoid-only CRS: the horizontal datum step is still the
                # Helmert shift (mirror of geodetic_to_wgs84's fallthrough)
                fb = self._helmert_from_wgs84(
                    np.stack([lon, lat, h], axis=1))
                lon, lat, h = fb[:, 0], fb[:, 1], fb[:, 2]
            if self.geoid is not None:
                h = h - self.geoid.undulation(lon, lat)
            return np.stack([np.asarray(lon, np.float64),
                             np.asarray(lat, np.float64),
                             np.asarray(h, np.float64)], axis=1)
        return self._helmert_from_wgs84(llh)

    def _helmert_from_wgs84(self, llh: np.ndarray) -> np.ndarray:
        x, y, z = _geodetic_to_ecef(llh[:, 0], llh[:, 1], llh[:, 2], _WGS84)
        ecef = np.stack([x, y, z], axis=1)
        if self.towgs84 is not None:
            ecef = _helmert(ecef, self.towgs84, inverse=True)
        lon, lat, h = _ecef_to_geodetic(ecef[:, 0], ecef[:, 1], ecef[:, 2],
                                        self.ell)
        return np.stack([lon, lat, h], axis=1)


# =============================================================== Projection

class Projection:
    """src->dst coordinate transform (reference Projection::new,
    reprojection.rs:16-47).

    ``backend``:
      - ``"auto"`` (default): system ``libproj`` when available (arbitrary
        CRSs, authoritative datum handling), else the builtin engine;
      - ``"proj"``: require libproj;
      - ``"builtin"``: force the self-contained engine.
    """

    def __init__(self, source_crs: str, target_crs: str,
                 backend: str = "auto") -> None:
        self.source_crs, self.target_crs = source_crs, target_crs
        self._proj = None
        self._src = self._dst = None
        if backend not in ("auto", "proj", "builtin"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend in ("auto", "proj"):
            from ..native import proj as _native_proj
            if _native_proj.AVAILABLE:
                self._proj = _native_proj.ProjTransformer(
                    source_crs, target_crs)
            elif backend == "proj":
                raise RuntimeError("libproj is not available on this system")
        if self._proj is None:
            self._src = _Crs(source_crs)
            self._dst = _Crs(target_crs)
        self.backend = "proj" if self._proj is not None else "builtin"

    def transform(self, position: np.ndarray) -> np.ndarray:
        """Transform one point (3,) or a column (N, 3)."""
        p = np.asarray(position, np.float64)
        single = p.ndim == 1
        p = p.reshape(-1, 3)
        if self._proj is not None:
            out = self._proj.transform(p)
        else:
            llh = self._src.to_geodetic(p)
            if not self._src._same_datum(self._dst):
                h_in = llh[:, 2].copy()
                llh = self._dst.geodetic_from_wgs84(
                    self._src.geodetic_to_wgs84(llh))
                # PROJ brackets the Helmert with push/pop v_3 for 2D CRS
                # pairs: the ellipsoidal height is restored after the
                # shift.  Geocentric endpoints are genuinely 3D, and a
                # geoid grid's whole point is the height change — keep
                # the shifted height in both cases.
                if self._src.kind != "geocent" and \
                        self._dst.kind != "geocent" and \
                        self._src.geoid is None and \
                        self._dst.geoid is None:
                    llh[:, 2] = h_in
            out = self._dst.from_geodetic(llh)
        return out[0] if single else out

    def transform_bounds(self, bounds: AABB) -> AABB:
        """Transform min/max corners, keeping the box axis-aligned
        (reference reprojection.rs:49-60)."""
        corners = self.transform(np.stack([bounds.min, bounds.max]))
        return AABB.from_min_max_unchecked(corners.min(axis=0),
                                           corners.max(axis=0))

    def close(self) -> None:
        if self._proj is not None:
            self._proj.close()
            self._proj = None


def reproject_point_cloud_within(
        buffer: Union[HostPointBuffer, PointBatch],
        source_crs: str, target_crs: str, backend: str = "auto") -> None:
    """In-place reprojection of Position3D (reference
    reprojection.rs:132-199).  A :class:`PointBatch`'s whole column goes
    to the host as f64, is transformed there, and comes back to the
    batch's own device in the column's dtype."""
    proj = Projection(source_crs, target_crs, backend=backend)
    if isinstance(buffer, PointBatch):
        col = buffer.data[att.POSITION_3D.name]
        out = proj.transform(col.cpu().numpy().astype(np.float64))
        buffer.data[att.POSITION_3D.name] = torch.from_numpy(
            out.astype(str(col.dtype).replace("torch.", ""))).to(col.device)
        return
    m = buffer.schema.member(att.POSITION_3D.name)
    out = proj.transform(buffer.get_converted(att.POSITION_3D))
    buffer.set(att.POSITION_3D.name,
               out.astype(m.dtype.np_component_dtype))


def reproject_point_cloud_between(
        source: HostPointBuffer, target: HostPointBuffer,
        source_crs: str, target_crs: str, backend: str = "auto") -> None:
    """src buffer -> dst buffer reprojection (reference
    reprojection.rs:201-260); buffers must have equal point counts."""
    if len(source) != len(target):
        raise ValueError(
            "target buffer must have the same number of points as the "
            "source buffer")
    proj = Projection(source_crs, target_crs, backend=backend)
    out = proj.transform(source.get_converted(att.POSITION_3D))
    m = target.schema.member(att.POSITION_3D.name)
    target.set(att.POSITION_3D.name, out.astype(m.dtype.np_component_dtype))
