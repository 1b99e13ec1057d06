"""The port's LAS/LAZ I/O against the JAX package's, on files the JAX
package writes from seeded numpy buffers: LAS point formats 0-10 and LAZ
formats 0-8, with extra bytes, a LAS 1.2 header and multi-chunk LAZ.  Both
readers must give the same columns exactly (default and wire schemas,
seeks, partial reads, a converting read), and the port's writer must write
the same bytes.  The port builds its own LASzip codec at first use."""

import numpy as np
import pytest

from pasture_tpu.buffers.host import HostPointBuffer as JHostPointBuffer
from pasture_tpu.io.las import LasHeader as JLasHeader
from pasture_tpu.io.las import LasPointFormat as JLasPointFormat
from pasture_tpu.io.las import LasReader as JLasReader
from pasture_tpu.io.las import LasWriter as JLasWriter
from pasture_tpu.io.las import point_schema_from_las_format as jschema_of
from pasture_tpu.layout import dtypes as jdt
from pasture_tpu.layout.attributes import PointAttribute as JPointAttribute
from pasture_tpu.layout.schema import PointSchema as JPointSchema

from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.io import open_reader, point_count, read_all, write_all
from pasture_tpu_torch.io.las import (LasHeader, LasPointFormat, LasReader,
                                      LasWriter, point_schema_from_las_format)
from pasture_tpu_torch.layout import dtypes as dt
from pasture_tpu_torch.layout.attributes import PointAttribute
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.native.laszip import _native

# values within each packed field's width, so that a round trip keeps them
_RANGES = {"ReturnNumber": (1, 8), "NumberOfReturns": (1, 8),
           "ScanDirectionFlag": (0, 2), "EdgeOfFlightLine": (0, 2),
           "ClassificationFlags": (0, 16), "ScannerChannel": (0, 4),
           "Classification": (0, 32)}
# the extra bytes a file may carry: (name, JAX dtype, port dtype)
_EXTRA = (("Reflectance", jdt.U32, dt.U32), ("Deviation", jdt.I16, dt.I16))


def _columns(members, n, rng):
    """Seeded columns for the members of a default LAS schema."""
    cols = {}
    for m in members:
        comp = np.dtype(m.dtype.np_component_dtype)
        shape = (n,) + tuple(m.dtype.np_shape)
        if m.name == "Position3D":
            cols[m.name] = np.round(rng.uniform(-50, 50, shape), 3)
        elif comp.kind == "f":
            cols[m.name] = rng.uniform(-1e3, 1e3, shape).astype(comp)
        else:
            info = np.iinfo(comp)
            lo, hi = _RANGES.get(m.name, (info.min, info.max))
            cols[m.name] = rng.integers(lo, hi, shape, dtype=comp,
                                        endpoint=m.name not in _RANGES)
    return cols


def _schemas(fmt: int, extra: bool):
    """The JAX and port schemas of format ``fmt``'s default point type
    (and the extra bytes attributes)."""
    jattrs = list(jschema_of(JLasPointFormat(fmt)).attributes)
    attrs = list(point_schema_from_las_format(LasPointFormat(fmt)).attributes)
    assert [a.name for a in jattrs] == [a.name for a in attrs]
    if extra:
        jattrs += [JPointAttribute(nm, jd) for nm, jd, _ in _EXTRA]
        attrs += [PointAttribute(nm, d) for nm, _, d in _EXTRA]
    return (JPointSchema.from_attributes(jattrs),
            PointSchema.from_attributes(attrs))


def _assert_same(got, want, what):
    assert list(got.schema.names) == list(want.schema.names), what
    assert len(got) == len(want), what
    for name in want.schema.names:
        g, w = got.get(name), want.get(name)
        assert g.dtype == w.dtype, (what, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


def _write_and_compare(tmp_path, fmt, n, compressed, extra=False,
                       version=None, chunk=None, seed=0):
    rng = np.random.default_rng(seed)
    jschema, schema = _schemas(fmt, extra)
    cols = _columns(jschema.members, n, rng)
    suffix = "laz" if compressed else "las"
    kw = {"write_extra_bytes": extra}
    if chunk is not None:
        kw["laz_chunk_size"] = chunk

    def header(cls, fmt_cls):
        if version is None:
            return None
        return cls(version=version, point_format=fmt_cls(fmt),
                   point_record_length=fmt_cls(fmt).len)

    ref_path = tmp_path / f"jax.{suffix}"
    with JLasWriter(ref_path, jschema,
                    header=header(JLasHeader, JLasPointFormat), **kw) as w:
        w.write(JHostPointBuffer.from_columns(jschema, cols))
    port_path = tmp_path / f"port.{suffix}"
    with LasWriter(port_path, schema, header=header(LasHeader, LasPointFormat),
                   **kw) as w:
        w.write(HostPointBuffer.from_columns(schema, cols))
    assert port_path.read_bytes() == ref_path.read_bytes()

    with JLasReader(ref_path) as jr, LasReader(ref_path) as r:
        assert r.header.point_count == jr.header.point_count == n
        assert r.header.version == jr.header.version
        assert r.header.is_compressed == compressed
        _assert_same(r.read_all(), jr.read_all(), "default schema")
        # seek into the middle and read in parts, past the end
        for start, count in ((n // 3, 7), (n - 5, 20), (0, n // 2 + 1)):
            assert r.seek_point(start) == jr.seek_point(start) == start
            _assert_same(r.read(count), jr.read(count),
                         f"seek {start}, read {count}")
            assert r.point_index() == jr.point_index()
    with JLasReader(ref_path, point_schema_matches_memory_layout=True) as jr, \
            LasReader(ref_path, point_schema_matches_memory_layout=True) as r:
        _assert_same(r.read_all(), jr.read_all(), "wire schema")
    return ref_path, schema


@pytest.mark.parametrize("fmt", range(11))
def test_las_formats_read_and_write_alike(tmp_path, fmt):
    """LAS 1.4 point formats 0-10; odd formats carry two extra bytes
    attributes."""
    _write_and_compare(tmp_path, fmt, 1500, compressed=False,
                       extra=bool(fmt % 2), seed=fmt)


@pytest.mark.parametrize("fmt", range(9))
def test_laz_formats_read_and_write_alike(tmp_path, fmt):
    """LAZ point formats 0-8 over three chunks of 700 points; formats 1 and
    6 carry extra bytes (the BYTE and BYTE14 items)."""
    _write_and_compare(tmp_path, fmt, 1900, compressed=True,
                       extra=fmt in (1, 6), chunk=700, seed=100 + fmt)


@pytest.mark.parametrize("compressed", (False, True))
def test_las12_header_and_native_converting_read(tmp_path, compressed):
    """A LAS 1.2 header (227 bytes) and a file large enough for the native
    deinterleave and the fused converting read (16 384 points and up), read
    into a narrower schema by both packages."""
    n = 20_000
    path, schema = _write_and_compare(tmp_path, 1, n, compressed,
                                      version=(1, 2), seed=7)
    assert _native(required=True) is not None
    with JLasReader(path) as jr:
        assert jr.header.header_size == 227
        jwant = jr.read(n, schema=JPointSchema.from_attributes(
            [a for a in jr.get_default_point_schema().attributes
             if a.name in ("Position3D", "Intensity", "Classification")]))
    narrow = PointSchema.from_attributes(
        [a for a in schema.attributes
         if a.name in ("Position3D", "Intensity", "Classification")])
    with open_reader(path) as r:
        assert r.header.header_size == 227
        got = r.read(n, schema=narrow)
    _assert_same(got, jwant, "converting read")
    assert point_count(path) == n
    _assert_same(read_all(path, narrow), got, "read_all")


def test_write_all_round_trip(tmp_path):
    """``write_all`` / ``read_all`` through the factory, by extension: every
    column back exactly but the positions, which the LAS encoding truncates
    to the 1 mm scale (Rust ``as`` parity), as the JAX package's own tests
    state."""
    rng = np.random.default_rng(3)
    schema = point_schema_from_las_format(LasPointFormat(3))
    buf = HostPointBuffer.from_columns(schema,
                                       _columns(schema.members, 300, rng))
    for suffix in ("las", "laz"):
        path = tmp_path / f"rt.{suffix}"
        write_all(buf, path)
        back = read_all(path)
        assert list(back.schema.names) == list(schema.names)
        for name in schema.names:
            if name == "Position3D":
                np.testing.assert_allclose(back.get(name), buf.get(name),
                                           rtol=0, atol=0.001)
            else:
                np.testing.assert_array_equal(back.get(name), buf.get(name))
