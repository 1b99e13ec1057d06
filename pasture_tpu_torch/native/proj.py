"""ctypes binding to the system PROJ library (arbitrary-CRS reprojection).

Parity target: the reference binds the C PROJ library through ``proj-sys``
FFI and transforms one point per ``proj_trans`` call
(pasture-algorithms/src/reprojection.rs:10-170: context create/destroy,
``proj_create_crs_to_crs``, per-point ``proj_trans``, ``Drop`` impl).

This binding keeps the same lifecycle (context + crs-to-crs object,
destroyed on ``close``/GC) but transforms whole columns per FFI call via
``proj_trans_generic`` — the vectorized host-boundary formulation this
framework uses everywhere (one call per batch, not per point).

The transform object is normalized with ``proj_normalize_for_visualization``
so coordinates are always (x=lon/east, y=lat/north, z) in GIS order,
independent of the EPSG axis-order convention — this matches the builtin
geodesy engine in :mod:`pasture_tpu_torch.algorithms.reprojection`.

``libproj`` is looked up at import time; if it is absent, ``AVAILABLE`` is
False and :class:`ProjTransformer` raises — callers (``Projection``) fall
back to the self-contained builtin engine.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

__all__ = ["AVAILABLE", "ProjTransformer", "proj_version"]

_FWD, _INV = 1, -1


def _load() -> Optional[ctypes.CDLL]:
    names = []
    found = ctypes.util.find_library("proj")
    if found:
        names.append(found)
    names += ["libproj.so.25", "libproj.so", "libproj.dylib"]
    for name in names:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        try:
            _declare(lib)
        except AttributeError:
            continue
        return lib
    return None


def _declare(lib: ctypes.CDLL) -> None:
    lib.proj_context_create.restype = ctypes.c_void_p
    lib.proj_context_create.argtypes = []
    lib.proj_context_destroy.restype = None
    lib.proj_context_destroy.argtypes = [ctypes.c_void_p]
    lib.proj_create_crs_to_crs.restype = ctypes.c_void_p
    lib.proj_create_crs_to_crs.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p]
    lib.proj_normalize_for_visualization.restype = ctypes.c_void_p
    lib.proj_normalize_for_visualization.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p]
    lib.proj_destroy.restype = None
    lib.proj_destroy.argtypes = [ctypes.c_void_p]
    lib.proj_trans_generic.restype = ctypes.c_size_t
    lib.proj_trans_generic.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_double), ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_double), ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_double), ctypes.c_size_t, ctypes.c_size_t]
    lib.proj_context_errno.restype = ctypes.c_int
    lib.proj_context_errno.argtypes = [ctypes.c_void_p]
    lib.proj_errno.restype = ctypes.c_int
    lib.proj_errno.argtypes = [ctypes.c_void_p]
    lib.proj_errno_string.restype = ctypes.c_char_p
    lib.proj_errno_string.argtypes = [ctypes.c_int]
    lib.proj_info.restype = _ProjInfo
    lib.proj_info.argtypes = []


class _ProjInfo(ctypes.Structure):
    _fields_ = [("major", ctypes.c_int), ("minor", ctypes.c_int),
                ("patch", ctypes.c_int), ("release", ctypes.c_char_p),
                ("version", ctypes.c_char_p), ("searchpath", ctypes.c_char_p),
                ("paths", ctypes.POINTER(ctypes.c_char_p)),
                ("path_count", ctypes.c_size_t)]


_LIB = _load()
AVAILABLE = _LIB is not None


def proj_version() -> Optional[str]:
    if not AVAILABLE:
        return None
    return _LIB.proj_info().version.decode()


class ProjTransformer:
    """One src->dst CRS transform (reference Projection::new,
    reprojection.rs:16-47 — context + crs_to_crs + normalize, freed on
    close).  Accepts anything PROJ accepts: "EPSG:xxxx", +proj strings,
    WKT, urns."""

    def __init__(self, source_crs: str, target_crs: str) -> None:
        if not AVAILABLE:
            raise RuntimeError("libproj is not available on this system")
        self._ctx = _LIB.proj_context_create()
        raw = _LIB.proj_create_crs_to_crs(
            self._ctx, source_crs.encode(), target_crs.encode(), None)
        if not raw:
            err = _LIB.proj_context_errno(self._ctx)
            msg = _LIB.proj_errno_string(err)
            _LIB.proj_context_destroy(self._ctx)
            self._ctx = None
            raise ValueError(
                f"PROJ cannot build {source_crs!r} -> {target_crs!r}: "
                f"{msg.decode() if msg else err}")
        self._pj = _LIB.proj_normalize_for_visualization(self._ctx, raw)
        _LIB.proj_destroy(raw)
        if not self._pj:
            _LIB.proj_context_destroy(self._ctx)
            self._ctx = None
            raise ValueError("proj_normalize_for_visualization failed")

    def transform(self, xyz: np.ndarray, inverse: bool = False) -> np.ndarray:
        """Transform an (N, 3) f64 column in one FFI call."""
        p = np.ascontiguousarray(np.asarray(xyz, np.float64))
        if p.ndim != 2 or p.shape[1] != 3:
            raise ValueError(f"expected (N, 3), got {p.shape}")
        out = p.copy()  # proj_trans_generic transforms in place
        n = out.shape[0]
        if n == 0:
            return out
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        stride = out.strides[0]
        x = ctypes.cast(ctypes.addressof(ptr.contents),
                        ctypes.POINTER(ctypes.c_double))
        y = ctypes.cast(ctypes.addressof(ptr.contents) + 8,
                        ctypes.POINTER(ctypes.c_double))
        z = ctypes.cast(ctypes.addressof(ptr.contents) + 16,
                        ctypes.POINTER(ctypes.c_double))
        done = _LIB.proj_trans_generic(
            self._pj, _INV if inverse else _FWD,
            x, stride, n, y, stride, n, z, stride, n,
            None, 0, 0)
        err = _LIB.proj_errno(self._pj)
        if err:
            # reset and report (PROJ latches errno on the PJ)
            msg = _LIB.proj_errno_string(err)
            raise ValueError(
                f"proj_trans_generic failed after {done}/{n} points: "
                f"{msg.decode() if msg else err}")
        return out

    def close(self) -> None:
        if getattr(self, "_pj", None):
            _LIB.proj_destroy(self._pj)
            self._pj = None
        if getattr(self, "_ctx", None):
            _LIB.proj_context_destroy(self._ctx)
            self._ctx = None

    def __del__(self) -> None:  # reference: Drop for Projection
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self) -> "ProjTransformer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
