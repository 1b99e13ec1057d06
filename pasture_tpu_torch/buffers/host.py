"""Host-side point buffers.

Pasture's two-axis buffer taxonomy (ownership x interleaved/columnar,
reference: pasture-core/src/containers/point_buffer.rs:17-654) collapses in a
device-first design: the canonical in-memory form is **columnar** (SoA numpy
arrays keyed by attribute name) because that is what streams to the device;
the **interleaved** form exists only as a (de)serialisation view at the I/O
boundary.  :class:`HostPointBuffer` therefore stores SoA columns and can

* materialise / ingest the exact interleaved wire bytes of its schema
  (``VectorBuffer`` semantics, point_buffer.rs:659-945),
* wrap external memory zero-copy (``ExternalMemoryBuffer``,
  point_buffer.rs:1479-1708) via ``from_interleaved(..., copy=False)``,
* convert between schemas (``BufferLayoutConverter`` contract) and
* filter/slice/append (``HashMapBuffer`` semantics, point_buffer.rs:950-1474).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Sequence, Union

import numpy as np

from ..layout.attributes import PointAttribute
from ..layout.conversion import SchemaConverter, convert_attribute_column
from ..layout.schema import PointSchema

__all__ = ["HostPointBuffer"]


class HostPointBuffer:
    """Columnar (SoA) buffer of N points with a :class:`PointSchema`."""

    def __init__(self, schema: PointSchema, columns: Dict[str, np.ndarray],
                 validate: bool = True) -> None:
        self.schema = schema
        self.columns = columns
        if validate:
            n = None
            for m in schema.members:
                if m.name not in columns:
                    raise ValueError(f"missing column {m.name!r}")
                col = columns[m.name]
                expected = (len(col),) + m.dtype.np_shape
                if col.shape != expected:
                    raise ValueError(
                        f"column {m.name!r} has shape {col.shape}, expected {expected}")
                if col.dtype != m.dtype.np_component_dtype:
                    raise ValueError(
                        f"column {m.name!r} has dtype {col.dtype}, "
                        f"expected {m.dtype.np_component_dtype}")
                if n is None:
                    n = len(col)
                elif len(col) != n:
                    raise ValueError("columns have differing lengths")

    # ---- constructors ---------------------------------------------------------
    @classmethod
    def empty(cls, schema: PointSchema, num_points: int = 0) -> "HostPointBuffer":
        cols = {
            m.name: np.zeros((num_points,) + m.dtype.np_shape, m.dtype.np_component_dtype)
            for m in schema.members
        }
        return cls(schema, cols, validate=False)

    @classmethod
    def from_columns(cls, schema: PointSchema, columns: Dict[str, np.ndarray]
                     ) -> "HostPointBuffer":
        cast = {}
        for m in schema.members:
            col = np.asarray(columns[m.name])
            want = m.dtype.np_component_dtype
            if col.dtype != want:
                col = col.astype(want)
            want_shape = m.dtype.np_shape
            if col.shape[1:] != want_shape:
                col = col.reshape((len(col),) + want_shape)
            cast[m.name] = np.ascontiguousarray(col)
        return cls(schema, cast)

    @classmethod
    def from_interleaved(cls, schema: PointSchema, raw: Union[bytes, bytearray, memoryview, np.ndarray],
                         copy: bool = True) -> "HostPointBuffer":
        """Ingest exact wire records.  With ``copy=False`` the columns are
        strided views into ``raw`` (zero-copy, the ``ExternalMemoryBuffer`` /
        mmap fast path — reference pasture-io/examples/fast_las_parsing.rs)."""
        np_dtype = schema.to_numpy_dtype()
        if isinstance(raw, np.ndarray) and raw.dtype == np_dtype:
            rec = raw
        else:
            buf = raw if isinstance(raw, np.ndarray) else np.frombuffer(raw, dtype=np.uint8)
            if isinstance(raw, np.ndarray) and raw.dtype != np.uint8:
                buf = raw.view(np.uint8)
            rec = buf.view(np_dtype)
        cols = {}
        for m in schema.members:
            col = rec[m.name]
            cols[m.name] = np.ascontiguousarray(col) if copy else col
        return cls(schema, cols, validate=False)

    # ---- core queries ---------------------------------------------------------
    def __len__(self) -> int:
        for c in self.columns.values():
            return len(c)
        return 0

    @property
    def num_points(self) -> int:
        return len(self)

    def get(self, attribute: Union[str, PointAttribute]) -> np.ndarray:
        """The raw column for an attribute (no conversion)."""
        name = attribute if isinstance(attribute, str) else attribute.name
        return self.columns[name]

    def get_converted(self, attribute: PointAttribute) -> np.ndarray:
        """Column converted to ``attribute.dtype``
        (reference ``view_attribute_with_conversion``, point_buffer.rs:331)."""
        member = self.schema.member(attribute.name)
        return convert_attribute_column(
            self.columns[attribute.name], member.dtype, attribute.dtype)

    def set(self, attribute: Union[str, PointAttribute], values: np.ndarray) -> None:
        name = attribute if isinstance(attribute, str) else attribute.name
        m = self.schema.member(name)
        values = np.asarray(values, dtype=m.dtype.np_component_dtype)
        if values.shape != (len(self),) + m.dtype.np_shape:
            raise ValueError(f"bad shape {values.shape} for column {name!r}")
        self.columns[name] = np.ascontiguousarray(values)

    # ---- per-point access (UntypedPoint / iterator parity) --------------------
    def point(self, index: int) -> Dict[str, np.ndarray]:
        """One point as an attribute-name -> value dict (the runtime-typed
        single-point view; reference ``UntypedPoint``,
        containers/untyped_point.rs:8-407)."""
        return {m.name: self.columns[m.name][index]
                for m in self.schema.members}

    def set_point(self, index: int, values: Dict[str, np.ndarray]) -> None:
        for name, v in values.items():
            m = self.schema.member(name)
            self.columns[name][index] = np.asarray(
                v, m.dtype.np_component_dtype)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate points as dicts (reference by-value point iterators,
        containers/point_iterators.rs:8-92)."""
        for i in range(len(self)):
            yield self.point(i)

    def transform_attribute(self, attribute: Union[str, PointAttribute], fn) -> None:
        """In-place column transform (reference ``transform_attribute``,
        point_buffer.rs:441)."""
        name = attribute if isinstance(attribute, str) else attribute.name
        m = self.schema.member(name)
        self.columns[name] = np.ascontiguousarray(
            fn(self.columns[name]), dtype=m.dtype.np_component_dtype)

    # ---- interleaved view ------------------------------------------------------
    def to_interleaved(self) -> np.ndarray:
        """Materialise the exact wire records (structured array, itemsize =
        ``schema.point_size``; padding bytes are zero)."""
        rec = np.zeros(len(self), dtype=self.schema.to_numpy_dtype())
        for m in self.schema.members:
            rec[m.name] = self.columns[m.name]
        return rec

    def to_bytes(self) -> bytes:
        return self.to_interleaved().tobytes()

    # ---- slicing / combination -------------------------------------------------
    def slice(self, start: int, stop: int) -> "HostPointBuffer":
        cols = {k: v[start:stop] for k, v in self.columns.items()}
        return HostPointBuffer(self.schema, cols, validate=False)

    def __getitem__(self, idx) -> "HostPointBuffer":
        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(self))
            if step != 1:
                cols = {k: v[idx] for k, v in self.columns.items()}
                return HostPointBuffer(self.schema, cols, validate=False)
            return self.slice(start, stop)
        if isinstance(idx, (list, np.ndarray)):
            cols = {k: v[idx] for k, v in self.columns.items()}
            return HostPointBuffer(self.schema, cols, validate=False)
        raise TypeError("index must be a slice or index array")

    def sort_by(self, attribute: Union[str, PointAttribute],
                component: Optional[int] = None) -> "HostPointBuffer":
        """New buffer sorted by an attribute (reference ``PointViewMut::
        sort_by``, containers/buffer_views.rs:242-247)."""
        name = attribute if isinstance(attribute, str) else attribute.name
        col = self.columns[name]
        key = col if component is None and col.ndim == 1 else \
            col[:, component if component is not None else 0]
        order = np.argsort(key, kind="stable")
        return self[order]

    def filter(self, mask: np.ndarray) -> "HostPointBuffer":
        """Predicate filtering (reference ``HashMapBuffer::filter``,
        point_buffer.rs:1047)."""
        mask = np.asarray(mask)
        cols = {k: v[mask] for k, v in self.columns.items()}
        return HostPointBuffer(self.schema, cols, validate=False)

    def append(self, other: "HostPointBuffer") -> "HostPointBuffer":
        """Concatenation; converts ``other`` to this schema if needed
        (reference ``OwningBufferExt::append``, point_buffer.rs:452-493)."""
        if other.schema != self.schema and not other.schema.compare_without_offsets(self.schema):
            other = other.convert_schema(self.schema, fill_missing_with_default=True)
        cols = {
            k: np.concatenate([self.columns[k], other.columns[k]])
            for k in self.columns
        }
        return HostPointBuffer(self.schema, cols, validate=False)

    @classmethod
    def concat(cls, buffers: Sequence["HostPointBuffer"]) -> "HostPointBuffer":
        if not buffers:
            raise ValueError("need at least one buffer")
        schema = buffers[0].schema
        cols = {
            m.name: np.concatenate([b.columns[m.name] for b in buffers])
            for m in schema.members
        }
        return cls(schema, cols, validate=False)

    # ---- column-wise construction ---------------------------------------------
    @classmethod
    def begin_push_attributes(cls, schema: PointSchema) -> "AttributePusher":
        """Column-wise incremental construction (reference
        ``HashMapBuffer::begin_push_attributes`` and its pusher,
        point_buffer.rs:1290-1474): push value ranges per attribute in any
        order; ``done()`` validates that every column has the same length.
        """
        return AttributePusher(schema)

    # ---- schema conversion -----------------------------------------------------
    def convert_schema(self, to_schema: PointSchema,
                       converter: Optional[SchemaConverter] = None,
                       fill_missing_with_default: bool = False) -> "HostPointBuffer":
        if converter is None:
            if fill_missing_with_default:
                converter = SchemaConverter.for_schemas_with_default(self.schema, to_schema)
            else:
                converter = SchemaConverter.for_schemas(self.schema, to_schema)
        out_cols = converter.convert(self.columns)
        return HostPointBuffer(to_schema, out_cols, validate=False)

    def __repr__(self) -> str:
        return f"HostPointBuffer({len(self)} points, {self.schema!r})"


class AttributePusher:
    """Accumulates per-attribute value ranges; see
    :meth:`HostPointBuffer.begin_push_attributes`."""

    def __init__(self, schema: PointSchema) -> None:
        self.schema = schema
        self._parts: Dict[str, list] = {m.name: [] for m in schema.members}

    def push_attribute_range(self, attribute: Union[str, PointAttribute],
                             values: np.ndarray) -> "AttributePusher":
        name = attribute if isinstance(attribute, str) else attribute.name
        m = self.schema.member(name)
        arr = np.asarray(values, m.dtype.np_component_dtype)
        if arr.shape[1:] != m.dtype.np_shape:
            arr = arr.reshape((-1,) + m.dtype.np_shape)
        self._parts[name].append(arr)
        return self

    def done(self) -> HostPointBuffer:
        """Validates equal column lengths (the reference's pusher panics on
        mismatch) and returns the buffer."""
        cols = {}
        length = None
        for name, parts in self._parts.items():
            col = (np.concatenate(parts) if parts
                   else np.zeros((0,) + self.schema.member(name).dtype.np_shape,
                                 self.schema.member(name).dtype.np_component_dtype))
            if length is None:
                length = len(col)
            elif len(col) != length:
                raise ValueError(
                    f"attribute {name!r} has {len(col)} values, expected "
                    f"{length} — all columns must receive the same count")
            cols[name] = np.ascontiguousarray(col)
        return HostPointBuffer(self.schema, cols, validate=False)
