"""Attribute datatype system.

Columnar re-design of pasture's ``PointAttributeDataType`` closed enum
(reference: pasture-core/src/layout/point_layout.rs:23-127).  Each datatype is
a small frozen descriptor that knows

* its wire size + minimal alignment (drives packed record layouts at the I/O
  boundary, exactly like the reference),
* its **host** numpy dtype/shape (exact semantics, f64 capable), and
* its **device** torch dtype under a configurable :class:`DevicePolicy`
  (the policy decides how 64-bit types land on device, and which torch
  dtype *carries* each logical dtype — see :data:`CARRIER_OF`).

Unlike the reference there is no interleaved in-memory representation on
device — device data is always SoA columns (one array per attribute); the
wire layout only matters for host-side (de)serialisation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "PointDtype",
    "DevicePolicy", "CARRIER_OF", "carrier_np_dtype", "torch_carrier",
    "U8", "U16", "U32", "U64",
    "I8", "I16", "I32", "I64",
    "F32", "F64",
    "VEC3U8", "VEC3U16", "VEC3I32", "VEC3F32", "VEC3F64", "VEC4U8",
    "byte_array", "custom",
    "SCALAR_DTYPES", "ALL_NAMED_DTYPES", "dtype_from_name",
]


@dataclasses.dataclass(frozen=True)
class PointDtype:
    """Descriptor of one attribute datatype.

    ``kind`` is one of ``"uint"``, ``"int"``, ``"float"``, ``"bytes"``,
    ``"custom"``.  ``shape`` is the per-point component shape: ``()`` for
    scalars, ``(3,)``/``(4,)`` for vectors, ``(n,)`` of u8 for byte arrays.
    """

    name: str
    kind: str
    bits: int                      # bits per component (8 for bytes/custom)
    shape: Tuple[int, ...]         # per-point component shape
    # for "custom": explicit size/alignment override (pasture Custom{size,align})
    _size: Optional[int] = None
    _align: Optional[int] = None

    # ---- sizes / alignment (mirrors PointAttributeDataType::size/min_alignment)
    @property
    def component_size(self) -> int:
        return self.bits // 8

    @property
    def num_components(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def size(self) -> int:
        """Wire size in bytes of one attribute value."""
        if self._size is not None:
            return self._size
        return self.component_size * self.num_components

    @property
    def min_alignment(self) -> int:
        """Natural alignment (component alignment, like repr(C) vectors)."""
        if self._align is not None:
            return self._align
        return self.component_size

    # ---- host (numpy) mapping -------------------------------------------------
    @property
    def np_component_dtype(self) -> np.dtype:
        if self.kind == "uint":
            return np.dtype(f"<u{self.component_size}")
        if self.kind == "int":
            return np.dtype(f"<i{self.component_size}")
        if self.kind == "float":
            return np.dtype(f"<f{self.component_size}")
        # bytes / custom: raw u8 payload
        return np.dtype("u1")

    @property
    def np_shape(self) -> Tuple[int, ...]:
        """Shape of the numpy payload for one point."""
        if self.kind in ("bytes", "custom"):
            return (self.size,)
        return self.shape

    def np_field(self) -> tuple:
        """(dtype, shape) pair usable inside a numpy structured dtype."""
        if self.np_shape == ():
            return (self.np_component_dtype, ())
        return (self.np_component_dtype, self.np_shape)

    # ---- predicates -----------------------------------------------------------
    @property
    def is_scalar(self) -> bool:
        return self.shape == () and self.kind in ("uint", "int", "float")

    @property
    def is_vector(self) -> bool:
        return self.shape != () and self.kind in ("uint", "int", "float")

    def __str__(self) -> str:  # matches pasture Display loosely
        return self.name

    def __repr__(self) -> str:
        return f"PointDtype({self.name})"


# ---- the closed set of named dtypes (pasture point_layout.rs:23-127) ----------
U8 = PointDtype("U8", "uint", 8, ())
U16 = PointDtype("U16", "uint", 16, ())
U32 = PointDtype("U32", "uint", 32, ())
U64 = PointDtype("U64", "uint", 64, ())
I8 = PointDtype("I8", "int", 8, ())
I16 = PointDtype("I16", "int", 16, ())
I32 = PointDtype("I32", "int", 32, ())
I64 = PointDtype("I64", "int", 64, ())
F32 = PointDtype("F32", "float", 32, ())
F64 = PointDtype("F64", "float", 64, ())
VEC3U8 = PointDtype("Vec3u8", "uint", 8, (3,))
VEC3U16 = PointDtype("Vec3u16", "uint", 16, (3,))
VEC3I32 = PointDtype("Vec3i32", "int", 32, (3,))
VEC3F32 = PointDtype("Vec3f32", "float", 32, (3,))
VEC3F64 = PointDtype("Vec3f64", "float", 64, (3,))
VEC4U8 = PointDtype("Vec4u8", "uint", 8, (4,))

SCALAR_DTYPES = (U8, U16, U32, U64, I8, I16, I32, I64, F32, F64)
ALL_NAMED_DTYPES = SCALAR_DTYPES + (VEC3U8, VEC3U16, VEC3I32, VEC3F32, VEC3F64, VEC4U8)

_BY_NAME = {d.name: d for d in ALL_NAMED_DTYPES}


def dtype_from_name(name: str) -> PointDtype:
    """Look up a :class:`PointDtype` by its pasture name (``"U8"``,
    ``"Vec3f64"``, ...; reference PointAttributeDataType FromStr,
    layout/point_attribute.rs)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown point dtype {name!r}") from None


def byte_array(n: int) -> PointDtype:
    """``ByteArray(n)`` — untyped blob of ``n`` bytes (point_layout.rs:44)."""
    return PointDtype(f"ByteArray({n})", "bytes", 8, (n,))


def custom(size: int, align: int = 1, tag: str = "") -> PointDtype:
    """``Custom{size, align}`` opaque datatype (point_layout.rs:47-52)."""
    return PointDtype(f"Custom({size},{align},{tag})", "custom", 8, (size,),
                      _size=size, _align=align)


# ---- device policy ------------------------------------------------------------
#: Carrier table, stated once: which numpy dtype (and so which torch dtype)
#: holds each *logical* device dtype.  torch on the CPU has no shifts, adds
#: or max for ``uint32`` and little for ``uint16``, so unsigned 16- and
#: 32-bit columns ride in the next wider signed type, holding the logical
#: value (u16: 0..65535 in int32; u32: 0..2**32-1 in int64).  The schema
#: keeps the logical dtype; ``PointBatch.to_host`` casts back.
CARRIER_OF = {
    "uint8": "uint8", "int8": "int8", "int16": "int16",
    "uint16": "int32", "int32": "int32",
    "uint32": "int64", "int64": "int64", "uint64": "int64",
    "float32": "float32", "float64": "float64",
}


def carrier_np_dtype(logical) -> np.dtype:
    """numpy dtype that carries the logical device dtype ``logical``."""
    return np.dtype(CARRIER_OF[np.dtype(logical).name])


def torch_carrier(logical):
    """torch dtype that carries the logical device dtype ``logical``."""
    import torch

    return getattr(torch, CARRIER_OF[np.dtype(logical).name])


@dataclasses.dataclass(frozen=True)
class DevicePolicy:
    """How host dtypes land on device.

    The default policy narrows 64-bit types to 32 bits (same values as
    ``numpy.astype`` to the 32-bit type gives); exact paths keep positions
    as LAS-native i32 local coordinates plus a scale/offset instead of
    relying on device f64 (see pasture_tpu_torch.buffers.device.PointBatch).
    Under ``EXACT`` a ``uint64`` column rides in ``int64`` as its bit
    pattern (values above 2**63-1 read negative on device and are restored
    by ``to_host``).
    """

    f64: str = "float32"
    u64: str = "uint32"
    i64: str = "int32"

    def np_dtype(self, d: PointDtype) -> np.dtype:
        """The *logical* device dtype of ``d`` (64-bit types narrowed as
        the policy says; bytes/custom payloads are u8)."""
        if d.kind == "float":
            return np.dtype(self.f64) if d.bits == 64 else np.dtype("float32")
        if d.kind == "uint":
            return np.dtype(self.u64 if d.bits == 64 else f"uint{d.bits}")
        if d.kind == "int":
            return np.dtype(self.i64 if d.bits == 64 else f"int{d.bits}")
        return np.dtype("uint8")

    def torch_dtype(self, d: PointDtype):
        """The torch dtype that carries ``d`` on device."""
        return torch_carrier(self.np_dtype(d))


#: Narrowing policy: 64-bit types land as 32-bit.
DevicePolicy.NARROW = DevicePolicy()
#: Exact policy: f64 and 64-bit ints keep their width.
DevicePolicy.EXACT = DevicePolicy(f64="float64", u64="uint64", i64="int64")
