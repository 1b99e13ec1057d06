"""Attribute and schema conversion with Rust-``as`` cast semantics.

Re-designs pasture's byte-level conversion machinery
(reference: pasture-core/src/layout/conversion/attribute_conversion.rs and
buffer_conversion.rs:98-450) as *vectorised column transforms*: instead of an
``unsafe fn(&[u8], &mut [u8])`` called once per point, a converter here maps a
whole numpy column at once (and the same rules are reproduced on device in
pasture_tpu_torch.ops).  The semantic contract is identical:

* dtype conversion behaves exactly like Rust's ``as`` operator
  (attribute_conversion.rs:188-264): int->int truncates/wraps, float->int
  truncates toward zero and **saturates** (NaN -> 0), int->float rounds to
  nearest, f64->f32 rounds (overflow -> inf).
* :class:`SchemaConverter` reproduces the ``BufferLayoutConverter`` contract
  (buffer_conversion.rs): name-matched default mappings, optional zero-filled
  defaults for missing sources, custom N:1 source fan-out mappings, and a
  per-mapping transform applied either to the *source* value (pre-conversion)
  or to the *target* value (post-conversion).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from .attributes import PointAttribute
from .dtypes import PointDtype
from .schema import PointSchema

__all__ = ["rust_as_cast", "convert_attribute_column", "SchemaConverter"]


def _float_to_int_saturating(x: np.ndarray, dst: np.dtype) -> np.ndarray:
    """Rust ``as`` float->int: truncate toward zero, saturate, NaN -> 0."""
    info = np.iinfo(dst)
    t = np.trunc(np.asarray(x, dtype=np.float64))
    nan_mask = np.isnan(t)
    t = np.where(nan_mask, 0.0, t)
    signed = info.min != 0
    hi = float(2.0 ** (info.bits - 1)) if signed else float(2.0 ** info.bits)
    lo = float(info.min)
    in_range = (t > lo - 1.0) & (t < hi)
    safe = np.where(in_range, t, 0.0)
    out = safe.astype(dst)
    out[t >= hi] = info.max
    out[t <= lo - 1.0] = info.min
    out[nan_mask] = 0
    return out


def rust_as_cast(x: np.ndarray, dst: np.dtype) -> np.ndarray:
    """Cast an array with Rust ``as`` operator semantics.

    Float -> int truncates toward zero, saturates at the type bounds, and
    maps NaN to 0 (attribute_conversion.rs:188-264)::

        >>> rust_as_cast(np.array([1.9, -1.9, 300.0, float("nan")]),
        ...              np.int8).tolist()
        [1, -1, 127, 0]
        >>> rust_as_cast(np.array([300], np.int16), np.uint8).tolist()  # wraps
        [44]
    """
    x = np.asarray(x)
    dst = np.dtype(dst)
    if x.dtype == dst:
        return x.copy()
    src_float = np.issubdtype(x.dtype, np.floating)
    dst_float = np.issubdtype(dst, np.floating)
    if src_float and not dst_float:
        return _float_to_int_saturating(x, dst)
    # int->int wraps (C truncation), int->float rounds, float->float rounds:
    # all match numpy astype.
    with np.errstate(over="ignore", invalid="ignore"):
        return x.astype(dst)


def convert_attribute_column(
    column: np.ndarray, from_dtype: PointDtype, to_dtype: PointDtype,
    assume_owned: bool = False
) -> np.ndarray:
    """Convert one SoA column between attribute dtypes.

    Mirrors ``get_converter_for_attributes`` (attribute_conversion.rs): unit
    conversion for equal dtypes, componentwise ``as`` casts otherwise.  The
    component count must match (scalar->scalar, vec3->vec3, ...).

    ``assume_owned``: the caller guarantees ``column`` is a fresh
    contiguous buffer it will not reuse (e.g. the native deinterleaver's
    output) — identity conversions then skip the defensive copy."""
    if from_dtype.name == to_dtype.name:
        if assume_owned and column.flags.c_contiguous:
            return column
        return np.array(column, copy=True)
    if from_dtype.kind in ("bytes", "custom") or to_dtype.kind in ("bytes", "custom"):
        if from_dtype.size != to_dtype.size:
            raise ValueError(
                f"cannot convert {from_dtype} -> {to_dtype}: raw byte sizes differ"
            )
        return np.array(column, copy=True)
    if from_dtype.num_components != to_dtype.num_components:
        raise ValueError(
            f"cannot convert {from_dtype} -> {to_dtype}: component counts differ"
        )
    return rust_as_cast(column, to_dtype.np_component_dtype)


@dataclasses.dataclass
class _Mapping:
    """One target attribute's source recipe
    (reference ``AttributeMapping``, buffer_conversion.rs:98-135)."""

    target: PointAttribute
    source: Optional[PointAttribute]          # None => fill with default (zeros)
    transform: Optional[Callable[[np.ndarray], np.ndarray]] = None
    transform_applies_to_source: bool = False
    transform_consumes_raw: bool = False      # raw source -> final target


class SchemaConverter:
    """Columnar schema-to-schema converter (``BufferLayoutConverter`` parity).

    Operates on dicts ``{attribute name: numpy column}``.  Several target
    attributes may read the same source attribute (bitfield fan-out), and a
    transform function (vectorised, value-shaped in/out) may run before or
    after the dtype conversion — exactly the reference's contract
    (buffer_conversion.rs:160-290).
    """

    def __init__(self, from_schema: PointSchema, to_schema: PointSchema,
                 fill_missing_with_default: bool = False) -> None:
        self.from_schema = from_schema
        self.to_schema = to_schema
        self._mappings: List[_Mapping] = []
        for target in to_schema.attributes:
            src_member = from_schema.get(target.name)
            if src_member is None:
                if not fill_missing_with_default:
                    raise ValueError(
                        f"target attribute {target.name!r} has no source in "
                        f"from_schema (use for_schemas_with_default to zero-fill)"
                    )
                self._mappings.append(_Mapping(target, None))
            else:
                self._mappings.append(_Mapping(target, src_member.attribute))

    # -- constructors mirroring the reference API -------------------------------
    @classmethod
    def for_schemas(cls, from_schema: PointSchema, to_schema: PointSchema):
        """Name-matched mappings; raises on missing source
        (reference ``for_layouts``, buffer_conversion.rs:139)."""
        return cls(from_schema, to_schema, fill_missing_with_default=False)

    @classmethod
    def for_schemas_with_default(cls, from_schema: PointSchema, to_schema: PointSchema):
        """Name-matched mappings; zero-fills targets with no source
        (reference ``for_layouts_with_default``)."""
        return cls(from_schema, to_schema, fill_missing_with_default=True)

    def set_custom_mapping(
        self, source: PointAttribute, target: PointAttribute
    ) -> None:
        self.set_custom_mapping_with_transformation(source, target, None, False)

    def set_custom_mapping_with_transformation(
        self,
        source: PointAttribute,
        target: PointAttribute,
        transform: Optional[Callable[[np.ndarray], np.ndarray]],
        applies_to_source: bool,
        consumes_raw: bool = False,
    ) -> None:
        """Reference ``set_custom_mapping_with_transformation``
        (buffer_conversion.rs:200-290).  ``transform`` receives the whole
        column (shape ``(N,)`` or ``(N, C)``) and must return the same shape
        and dtype class.

        ``consumes_raw``: the transform maps the RAW source column
        straight to the final target column and no dtype conversion runs
        on either side — required when the conversion itself must happen
        inside the transform (e.g. LAS positions, where the reference
        semantics are i32 -> f64 BEFORE scaling; a prior componentwise
        i32 -> f32 cast would truncate large coordinates)."""
        if not self.from_schema.has_attribute_with_name(source.name):
            raise ValueError(f"source attribute {source.name!r} not in from_schema")
        for m in self._mappings:
            if m.target.name == target.name:
                m.source = source
                m.transform = transform
                m.transform_applies_to_source = applies_to_source
                m.transform_consumes_raw = consumes_raw
                return
        raise ValueError(f"target attribute {target.name!r} not in to_schema")

    # -- execution --------------------------------------------------------------
    def convert(self, columns: Dict[str, np.ndarray],
                assume_owned: bool = False) -> Dict[str, np.ndarray]:
        """Convert SoA columns from ``from_schema`` into ``to_schema``.

        ``assume_owned``: identity conversions may return the input
        columns themselves (see convert_attribute_column)."""
        num_points = None
        for v in columns.values():
            num_points = len(v)
            break
        if num_points is None:
            num_points = 0
        out: Dict[str, np.ndarray] = {}
        served: set = set()  # source columns already returned as-is
        for m in self._mappings:
            tgt_dt = m.target.dtype
            if m.source is None:
                shape = (num_points,) + tgt_dt.np_shape
                out[m.target.name] = np.zeros(shape, tgt_dt.np_component_dtype)
                continue
            col = columns[m.source.name]
            src_dt = self.from_schema.attribute(m.source.name).dtype
            if m.transform is not None and m.transform_consumes_raw:
                out[m.target.name] = np.ascontiguousarray(
                    m.transform(col), dtype=tgt_dt.np_component_dtype)
                continue
            src_is_input = True
            if m.transform is not None and m.transform_applies_to_source:
                col = m.transform(col)   # fresh array — owning it is safe
                src_is_input = False
            # a source column may feed several targets (set_custom_mapping
            # can re-point m.source): only the FIRST identity use may alias
            # the input buffer, or a later in-place write to one output
            # would corrupt the other
            owned = assume_owned and (not src_is_input
                                      or m.source.name not in served)
            before = col
            col = convert_attribute_column(col, src_dt, tgt_dt,
                                           assume_owned=owned)
            if src_is_input and col is before:
                served.add(m.source.name)
            if m.transform is not None and not m.transform_applies_to_source:
                col = m.transform(col)
                col = np.ascontiguousarray(col, dtype=tgt_dt.np_component_dtype)
            out[m.target.name] = col
        return out
