"""The port's ASCII and 3D Tiles ``.pnts`` I/O against the JAX package's, on
files both packages write from the same seeded numpy columns: both readers
give equal columns, both writers give the same bytes for every writer option
(``rtc_center``, quantized positions, oct16p normals) and for hand-built
files with ``CONSTANT_RGBA``, ``RGB565`` and ``BATCH_ID``; ASCII parse
errors name the same line; tilesets round-trip to equal JSON; ``.pnts`` goes
through the factory."""

import io
import json
import struct
import warnings

import numpy as np
import pytest

from pasture_tpu.buffers.host import HostPointBuffer as JHostPointBuffer
from pasture_tpu.io import ascii as jascii
from pasture_tpu.io import tiles3d as jt3d
from pasture_tpu.io.tiles3d.feature_table import (
    FeatureTableDataReference as JRef)
from pasture_tpu.io.tiles3d.feature_table import (
    write_feature_table_header as j_write_ft)
from pasture_tpu.io.tiles3d.pnts import oct16p_encode as j_oct16p_encode
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.layout import dtypes as jdt
from pasture_tpu.layout.schema import PointSchema as JPointSchema

from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.io import (DEFAULT_FACTORY, AsciiReader, AsciiWriter,
                                  PntsReader, PntsWriter, open_reader,
                                  open_writer, read_all)
from pasture_tpu_torch.io import ascii as pascii
from pasture_tpu_torch.io import tiles3d as pt3d
from pasture_tpu_torch.io.tiles3d.feature_table import (
    FeatureTableDataReference, write_feature_table_header)
from pasture_tpu_torch.io.tiles3d.pnts import oct16p_decode, oct16p_encode
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout import dtypes as dt
from pasture_tpu_torch.layout.schema import PointSchema

N = 97                                   # not a multiple of 8: padding shows


def _pair(names, cols):
    """The same columns as a host buffer of each package (attributes by
    name, with the dtypes of ``cols``' carriers where they differ)."""
    def attr_of(module, dtypes, name):
        a = next(a for a in module.BUILTIN_ATTRIBUTES if a.name == name)
        if name == "Position3D" and cols[name].dtype == np.float32:
            return a.with_dtype(dtypes.VEC3F32)
        if name == "ColorRGB" and cols[name].dtype == np.uint8:
            return a.with_dtype(dtypes.VEC3U8)
        return a
    jschema = JPointSchema.from_attributes(
        [attr_of(jatt, jdt, n) for n in names])
    pschema = PointSchema.from_attributes(
        [attr_of(att, dt, n) for n in names])
    return (JHostPointBuffer.from_columns(jschema, dict(cols)),
            HostPointBuffer.from_columns(pschema, dict(cols)))


def _cols(seed=0, n=N):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return {
        "Position3D": rng.uniform(-50.0, 50.0, (n, 3)),
        "ColorRGB": rng.integers(0, 65536, (n, 3)).astype(np.uint16),
        "ColorRGBA": rng.integers(0, 256, (n, 4)).astype(np.uint8),
        "Normal": nrm.astype(np.float32),
        "Intensity": rng.integers(0, 65536, n).astype(np.uint16),
        "ReturnNumber": rng.integers(0, 8, n).astype(np.uint8),
        "NumberOfReturns": rng.integers(0, 8, n).astype(np.uint8),
        "Classification": rng.integers(0, 32, n).astype(np.uint8),
        "UserData": rng.integers(0, 256, n).astype(np.uint8),
        "PointSourceID": rng.integers(0, 65536, n).astype(np.uint16),
        "GpsTime": rng.uniform(0.0, 1e5, n),
        "NIR": rng.integers(0, 65536, n).astype(np.uint16),
        "ScanAngleRank": rng.integers(-90, 91, n).astype(np.int8),
        "EdgeOfFlightLine": rng.integers(0, 2, n).astype(np.uint8),
        "ScanDirectionFlag": rng.integers(0, 2, n).astype(np.uint8),
    }


def _assert_same_buffer(a, b):
    assert a.schema.names == b.schema.names
    assert [str(m.dtype) for m in a.schema.members] == \
        [str(m.dtype) for m in b.schema.members]
    for name in a.schema.names:
        np.testing.assert_array_equal(a.get(name), b.get(name), err_msg=name)


# ---- ASCII ---------------------------------------------------------------------

_ASCII_FORMATS = ["xyzirncuRGBtpedaI", "xyzsi", "xyzRGB"]
_ASCII_NAMES = {"x": "Position3D", "i": "Intensity", "r": "ReturnNumber",
                "n": "NumberOfReturns", "c": "Classification",
                "u": "UserData", "R": "ColorRGB", "t": "GpsTime",
                "p": "PointSourceID", "e": "EdgeOfFlightLine",
                "d": "ScanDirectionFlag", "a": "ScanAngleRank", "I": "NIR"}


@pytest.mark.parametrize("fmt", _ASCII_FORMATS)
@pytest.mark.parametrize("delimiter,precision", [(", ", 5), ("\t", 3)])
def test_ascii_write_and_read_match(tmp_path, fmt, delimiter, precision):
    cols = _cols(1)
    names = list(dict.fromkeys(_ASCII_NAMES[c] for c in fmt
                               if c in _ASCII_NAMES))
    jbuf, pbuf = _pair(names, {k: cols[k] for k in names})
    jpath, ppath = tmp_path / "j.txt", tmp_path / "p.txt"
    with jascii.AsciiWriter(jpath, fmt, delimiter=delimiter,
                            precision=precision) as w:
        w.write(jbuf)
    with AsciiWriter(ppath, fmt, delimiter=delimiter,
                     precision=precision) as w:
        w.write(pbuf)
    assert ppath.read_bytes() == jpath.read_bytes()
    with jascii.AsciiReader(jpath, fmt, delimiter) as r:
        jback = r.read_all()
    with AsciiReader(jpath, fmt, delimiter) as r:
        pback = r.read_all()
    _assert_same_buffer(jback, pback)
    # a partial read then the rest, as the reference's chunked reads
    with AsciiReader(jpath, fmt, delimiter) as r:
        head, rest = r.read(10), r.read(1000)
    assert len(head) == 10 and len(rest) == N - 10
    np.testing.assert_array_equal(head.get(names[0]),
                                  pback.get(names[0])[:10])


def test_ascii_schema_helpers_match():
    for fmt in _ASCII_FORMATS + ["xyzsssss", "RGBxyz"]:
        assert pascii.schema_from_format(fmt).names == \
            jascii.schema_from_format(fmt).names
        assert pascii.format_from_schema(pascii.schema_from_format(fmt)) \
            == jascii.format_from_schema(jascii.schema_from_format(fmt))
    for v in ["1.50000", "2.000", "7", "-0.10"]:
        assert pascii._trim_zeros(v) == jascii._trim_zeros(v)


@pytest.mark.parametrize("text,fmt", [
    ("1, 2, 3\n4, 5\n", "xyz"),                 # too few items, line 2
    ("1, 2, 3\n\n4, 5, x\n", "xyz"),            # bad float, line 2 of data
    ("1, 2, 3, 7\n1, 2, 3, 7.5\n", "xyzi"),     # bad integer, line 2
    ("1, 2, 3, 1\n1, 2, 3, 2\n", "xyze"),       # bad bool, line 2
])
def test_ascii_parse_errors_name_the_same_line(text, fmt):
    with pytest.raises(ValueError) as jerr:
        jascii.AsciiReader(io.StringIO(text), fmt).read_all()
    with pytest.raises(ValueError) as perr:
        AsciiReader(io.StringIO(text), fmt).read_all()
    assert str(perr.value) == str(jerr.value)
    assert "line" in str(perr.value)
    with pytest.raises(ValueError, match="can't interpret format literal"):
        AsciiReader(io.StringIO(""), "xyzQ")


def test_ascii_is_not_in_the_factory():
    assert "txt" not in DEFAULT_FACTORY._readers
    assert AsciiReader(io.StringIO(""), "xyz").get_metadata() \
        .number_of_points() is None


# ---- .pnts ---------------------------------------------------------------------

_PNTS_OPTIONS = {
    "plain": {},
    "rtc": {"rtc_center": [1000.5, -250.25, 12.0]},
    "quantized": {"quantize_positions": True},
    "quantized_rtc": {"quantize_positions": True,
                      "rtc_center": [100.0, 200.0, 300.0]},
    "oct16p": {"compress_normals": True},
    "all": {"quantize_positions": True, "compress_normals": True,
            "rtc_center": [3.0, 4.0, 5.0]},
}
_PNTS_NAMES = [["Position3D", "ColorRGB", "Normal"],
               ["Position3D", "ColorRGBA", "Intensity", "Normal"]]


@pytest.mark.parametrize("option", list(_PNTS_OPTIONS))
@pytest.mark.parametrize("names", _PNTS_NAMES, ids=["rgb", "rgba"])
def test_pnts_writers_write_the_same_bytes(tmp_path, option, names):
    cols = _cols(2)
    jbuf, pbuf = _pair(names, {k: cols[k] for k in names})
    kw = _PNTS_OPTIONS[option]
    jpath, ppath = tmp_path / "j.pnts", tmp_path / "p.pnts"
    with jt3d.PntsWriter(jpath, jbuf.schema, **kw) as w:
        w.write(jbuf.slice(0, 40))
        w.write(jbuf.slice(40, N))
    with PntsWriter(ppath, pbuf.schema, **kw) as w:
        w.write(pbuf.slice(0, 40))
        w.write(pbuf.slice(40, N))
    assert ppath.read_bytes() == jpath.read_bytes()
    for mode in ("ABSOLUTE", "RELATIVE_TO_CENTER"):
        jback = jt3d.PntsReader(
            jpath, getattr(jt3d.PntsReadPositionsMode, mode)).read_all()
        pback = PntsReader(
            jpath, getattr(pt3d.PntsReadPositionsMode, mode)).read_all()
        _assert_same_buffer(jback, pback)
    jm, pm = jt3d.PntsReader(jpath).get_metadata(), \
        PntsReader(jpath).get_metadata()
    assert pm.number_of_points() == jm.number_of_points() == N
    assert pm.bounds() is None and jm.bounds() is None
    for field in ("rtc_center", "points_length", "batch_length"):
        np.testing.assert_array_equal(
            np.asarray(pm.get_named_field(field), dtype=object),
            np.asarray(jm.get_named_field(field), dtype=object))


def _hand_pnts(write_ft, ref, header, body):
    h = struct.Struct("<4sIIIIII")
    header = {k: (ref(*v) if isinstance(v, tuple) else v)
              for k, v in header.items()}
    ftj = write_ft(header, 8, h.size)
    total = h.size + len(ftj) + len(body)
    return h.pack(b"pnts", 1, total, len(ftj), len(body), 0, 0) + ftj + body


def _hand_files():
    rng = np.random.default_rng(4)
    pos = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    q = rng.integers(0, 65536, (N, 3)).astype(np.uint16)
    c565 = rng.integers(0, 65536, N).astype(np.uint16)
    ids8 = rng.integers(0, 256, N).astype(np.uint8)
    ids32 = rng.integers(0, 2 ** 32, N).astype(np.uint32)
    nrm = rng.normal(size=(N, 3))
    enc = j_oct16p_encode(nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    return {
        "constant_rgba": ({"POINTS_LENGTH": N,
                           "CONSTANT_RGBA": [255, 128, 0, 200],
                           "POSITION": (0,)}, pos.tobytes()),
        "quantized": ({"POINTS_LENGTH": N,
                       "QUANTIZED_VOLUME_OFFSET": [10.0, 20.0, 30.0],
                       "QUANTIZED_VOLUME_SCALE": [2.0, 4.0, 8.0],
                       "POSITION_QUANTIZED": (0,)}, q.tobytes()),
        "rgb565_batch_id_short": ({"POINTS_LENGTH": N, "POSITION": (0,),
                                   "RGB565": (pos.nbytes,),
                                   "BATCH_ID": (pos.nbytes + c565.nbytes,)},
                                  pos.tobytes() + c565.tobytes()
                                  + rng.integers(0, 9, N).astype(
                                      np.uint16).tobytes()),
        "batch_id_byte": ({"POINTS_LENGTH": N, "POSITION": (0,),
                           "BATCH_ID": (pos.nbytes, "UNSIGNED_BYTE")},
                          pos.tobytes() + ids8.tobytes()),
        "batch_id_int_rtc": ({"POINTS_LENGTH": N, "POSITION": (0,),
                              "RTC_CENTER": [1.0, 2.0, 3.0],
                              "BATCH_ID": (pos.nbytes, "UNSIGNED_INT")},
                             pos.tobytes() + ids32.tobytes()),
        "oct16p": ({"POINTS_LENGTH": N, "POSITION": (0,),
                    "NORMAL_OCT16P": (pos.nbytes,)},
                   pos.tobytes() + enc.tobytes()),
    }


@pytest.mark.parametrize("case", list(_hand_files()))
def test_pnts_hand_built_files_read_the_same(case):
    header, body = _hand_files()[case]
    jdata = _hand_pnts(j_write_ft, JRef, header, body)
    pdata = _hand_pnts(write_feature_table_header,
                       FeatureTableDataReference, header, body)
    assert pdata == jdata
    _assert_same_buffer(jt3d.PntsReader(jdata).read_all(),
                        PntsReader(jdata).read_all())


def test_pnts_writer_warns_on_point_id_and_oct16p_matches(tmp_path):
    cols = _cols(5)
    pbuf = HostPointBuffer.from_columns(
        PointSchema.from_attributes([att.POSITION_3D, att.POINT_ID]),
        {"Position3D": cols["Position3D"],
         "PointID": np.arange(N, dtype=np.uint64)})
    with pytest.warns(UserWarning, match="PointID"):
        PntsWriter(tmp_path / "x.pnts", pbuf.schema)
    nrm = cols["Normal"].astype(np.float64)
    np.testing.assert_array_equal(oct16p_encode(nrm), j_oct16p_encode(nrm))
    np.testing.assert_array_equal(
        oct16p_decode(oct16p_encode(nrm)),
        jt3d.pnts.oct16p_decode(j_oct16p_encode(nrm)))


def test_pnts_through_the_factory(tmp_path):
    cols = _cols(6)
    names = ["Position3D", "ColorRGB"]
    jbuf, pbuf = _pair(names, {k: cols[k] for k in names})
    path = tmp_path / "x.pnts"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with open_writer(path, pbuf.schema) as w:
            assert isinstance(w, PntsWriter)
            w.write(pbuf)
    with open_reader(path) as r:
        assert isinstance(r, PntsReader)
        assert r.get_metadata().number_of_points() == N
    with jt3d.PntsWriter(tmp_path / "j.pnts", jbuf.schema) as w:
        w.write(jbuf)
    assert path.read_bytes() == (tmp_path / "j.pnts").read_bytes()
    back = read_all(path)
    _assert_same_buffer(back, jt3d.PntsReader(path).read_all())
    # u16 colours go to the wire's u8 as a Rust ``as`` cast: the low byte
    np.testing.assert_array_equal(back.get("ColorRGB"),
                                  cols["ColorRGB"].astype(np.uint8))
    np.testing.assert_array_equal(
        back.get("Position3D"), cols["Position3D"].astype(np.float32))


# ---- tileset.json --------------------------------------------------------------

def _tileset(mod):
    child = (mod.TilesetBuilder().geometric_error(0.5)
             .bounding_volume(mod.BoundingVolume.sphere([1, 2, 3], 4.5))
             .content("child.pnts").refinement(mod.Refinement.REPLACE)
             .build())
    root = (mod.TilesetBuilder().geometric_error(70.0)
            .refinement(mod.Refinement.ADD)
            .bounding_volume(mod.BoundingVolume.region(
                -1.3197, 0.6988, -1.3196, 0.6989, 0.0, 20.0))
            .viewer_request_volume(mod.BoundingVolume.box(
                [0, 0, 10], [100, 0, 0], [0, 100, 0], [0, 0, 10]))
            .content("root.pnts", mod.BoundingVolume.sphere([0, 0, 0], 9.0))
            .transform(list(np.eye(4).ravel()))
            .add_child(child).build())
    return mod.Tileset(root=root, geometric_error=100.0)


def test_tilesets_round_trip_to_equal_json(tmp_path):
    jts, pts = _tileset(jt3d), _tileset(pt3d)
    assert pts.to_json() == jts.to_json()
    jt3d.write_tileset(jts, tmp_path / "j.json")
    pt3d.write_tileset(pts, tmp_path / "p.json")
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    back = pt3d.read_tileset(tmp_path / "j.json")
    assert back.to_json() == jts.to_json()
    assert json.loads((tmp_path / "p.json").read_text()) == jts.to_json()


def test_chip_smoke_formats_rehearsal(tmp_path, monkeypatch):
    """``chip_smoke.py``'s path_formats at a small size on the CPU: the
    three ``.pnts`` forms and the ASCII file read back as written, the
    tools' lines checked, and the ``.pnts`` fold (bounds streamed: the
    header has none) equal to a one-shot voxelization."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "FILE_CHUNK", 4096)
    monkeypatch.setattr(chip_smoke, "FILE_TILE", 256)
    monkeypatch.setattr(chip_smoke, "FORMATS_ASCII_N", 1500)
    gate = chip_smoke.gate_formats(tmp_path, chip_smoke.formats_survey(12_000),
                                   "cpu")
    assert set(gate["forms"]) == {"rtc", "quantized", "oct16p", "ascii"}
    assert gate["info_lines_checked"] > 0
    fold = chip_smoke.gate_file_to_map(gate["paths"]["rtc"], "cpu")
    assert fold["gate_passed"] and fold["voxels"] > 0
