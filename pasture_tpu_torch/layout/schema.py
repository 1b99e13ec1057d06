"""PointSchema — ordered, typed description of one point record.

Columnar counterpart of pasture's ``PointLayout``
(reference: pasture-core/src/layout/point_layout.rs:646-1034).  The schema
fixes *names, dtypes, order and wire offsets* of attributes.  On device the
offsets are irrelevant (data is SoA), but they drive the host I/O boundary:
``to_numpy_dtype()`` produces the exact interleaved record layout, matching
pasture's repr(C)-style or packed placement rules byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .attributes import PointAttribute
from .dtypes import PointDtype


def align_to(value: int, alignment: int) -> int:
    """Round ``value`` up to a multiple of ``alignment``
    (reference: pasture-core/src/math/arithmetic.rs:8-60)."""
    if alignment <= 1:
        return value
    return (value + alignment - 1) // alignment * alignment


@dataclasses.dataclass(frozen=True)
class SchemaMember:
    """An attribute placed at a byte offset within the record
    (reference ``PointAttributeMember``, point_layout.rs:354-443)."""

    attribute: PointAttribute
    offset: int

    @property
    def name(self) -> str:
        return self.attribute.name

    @property
    def dtype(self) -> PointDtype:
        return self.attribute.dtype

    @property
    def size(self) -> int:
        return self.attribute.size

    def byte_range_within_point(self) -> Tuple[int, int]:
        return (self.offset, self.offset + self.size)


#: Alignment request for a schema field: ``"default"`` (the dtype's
#: natural repr(C) alignment) or an explicit byte alignment ``N``
#: (packed layouts; reference FieldAlignment, layout/point_layout.rs).
FieldAlignment = Union[str, int]


class PointSchema:
    """Ordered attribute list + record size/alignment.

    Two placement modes, as in the reference:

    * ``"default"`` — repr(C)-style: each field at the next offset aligned to
      its natural alignment; record size rounded up to the max alignment.
    * packed ``N`` — field alignment is ``min(natural, N)``; with ``N == 1``
      the record is the tight byte concatenation (LAS wire records).

    Offset semantics match ``PointLayout::add_attribute``
    (point_layout.rs:767-777)::

        >>> from pasture_tpu_torch.layout import attributes as att
        >>> s = PointSchema.from_attributes(
        ...     [att.CLASSIFICATION, att.POSITION_3D, att.INTENSITY])
        >>> s.offset_of("Classification"), s.offset_of("Position3D")
        (0, 8)
        >>> s.point_size  # 8 + 24 + 2 -> padded to alignment 8
        40
        >>> packed = PointSchema.from_attributes_packed(
        ...     [att.CLASSIFICATION, att.POSITION_3D, att.INTENSITY])
        >>> packed.offset_of("Position3D"), packed.point_size
        (1, 27)
    """

    def __init__(self) -> None:
        self._members: List[SchemaMember] = []
        self._by_name: Dict[str, int] = {}
        self._max_align: int = 1

    # ---- constructors ---------------------------------------------------------
    @classmethod
    def from_attributes(cls, attributes: Iterable[PointAttribute]) -> "PointSchema":
        s = cls()
        for a in attributes:
            s.add_attribute(a, "default")
        return s

    @classmethod
    def from_attributes_packed(
        cls, attributes: Iterable[PointAttribute], alignment: int = 1
    ) -> "PointSchema":
        s = cls()
        for a in attributes:
            s.add_attribute(a, alignment)
        return s

    # ---- mutation -------------------------------------------------------------
    def add_attribute(
        self, attribute: PointAttribute, alignment: FieldAlignment = "default"
    ) -> "PointSchema":
        """Append an attribute (reference ``PointLayout::add_attribute``,
        point_layout.rs:751-800).  Duplicate names are an error."""
        if attribute.name in self._by_name:
            raise ValueError(f"duplicate attribute {attribute.name!r} in schema")
        natural = attribute.dtype.min_alignment
        if alignment == "default":
            field_align = natural
        else:
            field_align = min(natural, int(alignment))
        offset = align_to(self._unpadded_size(), field_align)
        self._by_name[attribute.name] = len(self._members)
        self._members.append(SchemaMember(attribute, offset))
        self._max_align = max(self._max_align, field_align)
        return self

    # ---- queries --------------------------------------------------------------
    def _unpadded_size(self) -> int:
        if not self._members:
            return 0
        last = self._members[-1]
        return last.offset + last.size

    @property
    def members(self) -> Tuple[SchemaMember, ...]:
        return tuple(self._members)

    @property
    def attributes(self) -> Tuple[PointAttribute, ...]:
        return tuple(m.attribute for m in self._members)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(m.name for m in self._members)

    def size_of_point_entry(self) -> int:
        """Record stride in bytes incl. trailing padding
        (reference point_layout.rs ``size_of_point_entry``)."""
        return align_to(self._unpadded_size(), self._max_align)

    @property
    def point_size(self) -> int:
        return self.size_of_point_entry()

    @property
    def alignment(self) -> int:
        return self._max_align

    def __len__(self) -> int:
        return len(self._members)

    def __iter__(self):
        return iter(self._members)

    def __contains__(self, attribute) -> bool:
        return self.has_attribute(attribute)

    def has_attribute_with_name(self, name: str) -> bool:
        return name in self._by_name

    def has_attribute(self, attribute: Union[PointAttribute, str]) -> bool:
        """Name + dtype match for PointAttribute; name-only for str."""
        if isinstance(attribute, str):
            return attribute in self._by_name
        idx = self._by_name.get(attribute.name)
        return idx is not None and self._members[idx].dtype == attribute.dtype

    def index_of(self, name: str) -> int:
        if name not in self._by_name:
            raise KeyError(f"attribute {name!r} not in schema")
        return self._by_name[name]

    def member(self, name: str) -> SchemaMember:
        return self._members[self.index_of(name)]

    def get(self, name: str) -> Optional[SchemaMember]:
        idx = self._by_name.get(name)
        return self._members[idx] if idx is not None else None

    def attribute(self, name: str) -> PointAttribute:
        return self.member(name).attribute

    def offset_of(self, name: str) -> int:
        return self.member(name).offset

    def compare_without_offsets(self, other: "PointSchema") -> bool:
        """True if both schemas have the same (name, dtype) multiset order-
        insensitively (reference ``compare_without_offsets``)."""
        if len(self) != len(other):
            return False
        mine = {(m.name, m.dtype.name) for m in self._members}
        theirs = {(m.name, m.dtype.name) for m in other._members}
        return mine == theirs

    # ---- equality: members incl. offsets, like the reference -----------------
    def __eq__(self, other) -> bool:
        if not isinstance(other, PointSchema):
            return NotImplemented
        return self._members == other._members

    def __hash__(self) -> int:
        return hash(tuple(self._members))

    def __repr__(self) -> str:
        inner = ", ".join(f"{m.name}@{m.offset}:{m.dtype}" for m in self._members)
        return f"PointSchema[{self.point_size}B]({inner})"

    # ---- host interop ---------------------------------------------------------
    def to_numpy_dtype(self) -> np.dtype:
        """Numpy structured dtype with explicit offsets + itemsize — the exact
        interleaved wire layout of one record."""
        names, formats, offsets = [], [], []
        for m in self._members:
            names.append(m.name)
            formats.append(m.dtype.np_field())
            offsets.append(m.offset)
        return np.dtype({
            "names": names,
            "formats": formats,
            "offsets": offsets,
            "itemsize": self.size_of_point_entry(),
        })

    def subset(self, names: Sequence[str]) -> "PointSchema":
        """New packed schema containing only ``names`` in the given order."""
        return PointSchema.from_attributes_packed(
            [self.attribute(n) for n in names]
        )

    @classmethod
    def from_numpy_dtype(cls, np_dtype: np.dtype) -> "PointSchema":
        """Schema from a numpy structured dtype — the Python analog of the
        reference's ``#[derive(PointType)]`` proc-macro
        (pasture-derive/src/lib.rs:422-475): field names, dtypes and
        *offsets* are taken from the struct definition.

        Scalar fields map to scalar attribute dtypes, ``(3,)``/``(4,)``
        subarrays to the vector dtypes, other u8 subarrays to byte arrays.
        """
        from . import dtypes as dt

        if np_dtype.names is None:
            raise ValueError("expected a structured numpy dtype")
        schema = cls()
        offsets = []
        for name in np_dtype.names:
            field_dtype, field_offset = np_dtype.fields[name][:2]
            if field_dtype.subdtype is not None:
                base, shape = field_dtype.subdtype
            else:
                base, shape = field_dtype, ()
            kind = {"u": "uint", "i": "int", "f": "float"}.get(base.kind)
            if kind is None:
                raise ValueError(f"unsupported field kind {base.kind!r}")
            if shape == ():
                pd = dt.PointDtype(
                    {"uint": "U", "int": "I", "float": "F"}[kind]
                    + str(base.itemsize * 8), kind, base.itemsize * 8, ())
                pd = dt.dtype_from_name(pd.name)
            elif shape in ((3,), (4,)):
                names = {("uint", 8, (3,)): dt.VEC3U8,
                         ("uint", 16, (3,)): dt.VEC3U16,
                         ("int", 32, (3,)): dt.VEC3I32,
                         ("float", 32, (3,)): dt.VEC3F32,
                         ("float", 64, (3,)): dt.VEC3F64,
                         ("uint", 8, (4,)): dt.VEC4U8}
                key = (kind, base.itemsize * 8, shape)
                if key not in names:
                    raise ValueError(f"no vector dtype for {key}")
                pd = names[key]
            elif kind == "uint" and base.itemsize == 1:
                pd = dt.byte_array(int(np.prod(shape)))
            else:
                raise ValueError(f"unsupported field shape {shape}")
            offsets.append((name, pd, field_offset))
        # place fields at their declared offsets
        for name, pd, off in sorted(offsets, key=lambda x: x[2]):
            idx = len(schema._members)
            schema._by_name[name] = idx
            schema._members.append(SchemaMember(
                PointAttribute(name, pd), off))
            schema._max_align = max(schema._max_align, pd.min_alignment)
        return schema
