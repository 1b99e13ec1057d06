"""K9, the LAS record decode, and the record path of ``sharded_read_all``:
K9's plain version (what a CPU tensor runs, and what the CUDA kernel
equals bit for bit on the card) against numpy's decode of the same
records; ``LasReader.read_records_into`` against the file's bytes; the
record path of ``sharded_read_all`` against its host path on the same
files, ranks and capacity (every column, the padding rows, the count), and
the inputs that take the host path (LAZ, ``.pnts``, a schema that needs the
flags).  On the card only: the kernel against the plain version, and the
staging that a second call reuses.  Imports nothing of JAX."""

import importlib.util
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from pasture_tpu_torch.buffers.device import PointBatch, column_carrier
from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.io import open_reader, write_all
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout import dtypes as dt
from pasture_tpu_torch.layout.dtypes import DevicePolicy
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.ops.kernels import las_decode_kernel as k9
from pasture_tpu_torch.parallel import ingest
from pasture_tpu_torch.parallel.mesh import Mesh

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
POS, INT, CLS = "Position3D", "Intensity", "Classification"
SHEET_SCHEMA = PointSchema.from_attributes(
    [att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION])
# RD New: the sheet's offsets, 1 mm scale
SCALE, OFFSET = (0.001, 0.001, 0.001), (136000.0, 455000.0, -3.5)


def _lasfile():
    """The benchmark's format-6 LAS writer (imports nothing of the
    program)."""
    spec = importlib.util.spec_from_file_location("bench_lasfile",
                                                  BENCH / "lasfile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(rng, n, layout):
    """``n`` random records of the structured dtype ``layout`` as a flat
    uint8 tensor, and the structured array."""
    rec = np.frombuffer(rng.integers(0, 256, n * layout.itemsize,
                                     dtype=np.uint8).tobytes(), layout)
    return torch.from_numpy(rec.view(np.uint8).copy()), rec


def _want_positions(local, scale, offset, dtype):
    return (local.astype(np.float64) * np.asarray(scale)
            + np.asarray(offset)).astype(dtype)


# (layout, position offset, fields as (name, column dtype))
LAYOUTS = {
    "format6": (np.dtype([("xyz", "<i4", 3), ("intensity", "<u2"),
                          ("returns", "u1"), ("flags", "u1"),
                          ("classification", "u1"), ("user", "u1"),
                          ("angle", "<i2"), ("source", "<u2"),
                          ("gps", "<f8")]),
                0, (("intensity", torch.int32), ("classification",
                                                  torch.uint8))),
    "format1": (np.dtype([("xyz", "<i4", 3), ("intensity", "<u2"),
                          ("flags", "u1"), ("classification", "u1"),
                          ("angle", "i1"), ("user", "u1"),
                          ("source", "<u2"), ("gps", "<f8")]),
                0, (("intensity", torch.int32),)),
    "wide": (np.dtype([("pad", "u1", 3), ("xyz", "<i4", 3),
                       ("rgb", "<u2", 3), ("gps", "<f8"), ("id", "<u4"),
                       ("angle", "<i2")]),
             3, (("rgb", torch.int32), ("gps", torch.float64),
                 ("id", torch.int64), ("angle", torch.int16))),
}


def _fields(layout, names, capacity, device="cpu"):
    """K9's fields for ``names`` and their zeroed columns."""
    out = []
    for name, dtype in names:
        sub, shape = layout.fields[name][0], layout[name].shape
        col = torch.zeros((capacity,) + shape, dtype=dtype, device=device)
        out.append((layout.fields[name][1], sub.base.itemsize, col))
    return out


@pytest.mark.parametrize("pos_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(LAYOUTS))
def test_plain_decode_equals_numpy(case, pos_dtype):
    """Every row of a chunk landing at a row offset: positions as
    ``float64(x) * scale + offset`` rounded to the column, fields copied and
    widened to their carrier; rows outside the chunk untouched."""
    layout, pos_offset, names = LAYOUTS[case]
    rng = np.random.default_rng(3)
    n, row, cap = 1003, 17, 1100
    raw, rec = _records(rng, n, layout)
    positions = torch.zeros((cap, 3), dtype=pos_dtype)
    fields = _fields(layout, names, cap)
    k9.las_records_decode(raw, n, layout.itemsize, row, SCALE, OFFSET,
                          pos_offset, positions, fields)
    want = _want_positions(rec["xyz"], SCALE, OFFSET,
                           torch.empty((), dtype=pos_dtype).numpy().dtype)
    got = positions.numpy()
    assert (got[row:row + n].view(np.uint8)
            == want.view(np.uint8).reshape(n, -1)).all()
    assert not got[:row].any() and not got[row + n:].any()
    for (name, dtype), (_, _, col) in zip(names, fields):
        c = col.numpy()
        np.testing.assert_array_equal(
            c[row:row + n], rec[name].astype(c.dtype))
        assert not c[:row].any() and not c[row + n:].any()


def test_plain_decode_rounds_rd_new_to_nearest():
    """Locals across the sheet's range: the float32 positions are the
    float64 values rounded to nearest (a float32 step is 1.6 cm in x here),
    which float32 arithmetic would miss."""
    rng = np.random.default_rng(5)
    n = 100000
    layout = LAYOUTS["format6"][0]
    rec = np.zeros(n, layout)
    rec["xyz"] = rng.integers(0, (2_000_000, 2_500_000, 60_000), (n, 3))
    raw = torch.from_numpy(rec.view(np.uint8).copy())
    positions = torch.empty((n, 3), dtype=torch.float32)
    k9.las_records_decode(raw, n, layout.itemsize, 0, SCALE, OFFSET, 0,
                          positions, [])
    want = _want_positions(rec["xyz"], SCALE, OFFSET, np.float32)
    np.testing.assert_array_equal(positions.numpy(), want)
    f32 = (rec["xyz"].astype(np.float32) * np.float32(0.001)
           + np.asarray(OFFSET, np.float32))
    assert (f32 != want).any()


def test_decode_rejects_what_it_does_not_take():
    rec = torch.zeros(300, dtype=torch.uint8)
    pos = torch.zeros((10, 3))
    col = torch.zeros(10, dtype=torch.int32)
    bad = [
        dict(records=rec.to(torch.int8)),
        dict(record_size=8),
        dict(n=11),
        dict(row=1),
        dict(pos_offset=20),
        dict(positions=torch.zeros((10, 2))),
        dict(positions=torch.zeros((10, 3), dtype=torch.int32)),
        dict(fields=[(28, 4, col)]),
        dict(fields=[(0, 4, torch.zeros(10, dtype=torch.int16))]),
        dict(fields=[(0, 2, torch.zeros(10, dtype=torch.float32))]),
        dict(fields=[(0, 3, col)]),
        dict(fields=[(0, 1, col)] * 17),
        dict(fields=[(0, 2, torch.zeros((2, 10), dtype=torch.int32).T)]),
    ]
    for change in bad:
        args = dict(records=rec, n=10, record_size=30, row=0, scale=SCALE,
                    offset=OFFSET, pos_offset=0, positions=pos,
                    fields=[(12, 2, col)])
        args.update(change)
        with pytest.raises(ValueError):
            k9.las_records_decode(**args)


def test_supports_record_size_and_counts_bytes():
    assert k9.supports_record_size(20) and k9.supports_record_size(3047)
    assert not k9.supports_record_size(3048)
    assert not k9.supports_record_size(11)
    pos = torch.zeros((4, 3))
    fields = [(12, 2, torch.zeros(4, dtype=torch.int32)),
              (16, 1, torch.zeros(4, dtype=torch.uint8))]
    assert k9.record_bytes(15_000_000, 30, pos, fields) \
        == 15_000_000 * (30 + 12 + 4 + 1)


# ---- the record-range read ----------------------------------------------------

def _sheet_file(path, n, seed, offset=OFFSET):
    rng = np.random.default_rng(seed)
    local = rng.integers(-(2 ** 31), 2 ** 31 - 1, (n, 3)).astype(np.int32)
    _lasfile().write_las(path, local,
                         rng.integers(0, 65536, n).astype(np.uint16),
                         rng.integers(0, 256, n).astype(np.uint8),
                         scale=SCALE, offset=offset)
    return str(path)


def test_read_records_into_equals_the_file(tmp_path):
    path = _sheet_file(tmp_path / "a.las", 5000, 1)
    data = Path(path).read_bytes()
    with open_reader(path) as r:
        assert r.reads_records() and r.record_size == 30
        at = r.header.offset_to_point_data
        dst = np.zeros(3000 * 30, np.uint8)
        with ThreadPoolExecutor(max_workers=3) as ex:
            got = list(ex.map(
                lambda a: r.read_records_into(dst[(a - 1000) * 30:], a, 1000),
                (1000, 2000, 3000)))
        assert got == [30000] * 3
        assert dst.tobytes() == data[at + 30000:at + 120000]
        assert r.point_index() == 0
        with pytest.raises(ValueError):
            r.read_records_into(dst, 4500, 501)
        with pytest.raises(ValueError):
            r.read_records_into(np.zeros(10, np.uint8), 0, 1)


def test_read_records_into_needs_an_uncompressed_file(tmp_path):
    buf = HostPointBuffer.from_columns(
        PointSchema.from_attributes([att.POSITION_3D]),
        {POS: np.round(np.random.default_rng(0).uniform(0, 9, (50, 3)), 3)})
    write_all(buf, tmp_path / "a.laz")
    with open_reader(tmp_path / "a.laz") as r:
        assert not r.reads_records()
        with pytest.raises(ValueError):
            r.read_records_into(np.zeros(1000, np.uint8), 0, 1)


# ---- sharded_read_all: the record path against the host path ---------------

def _host_path(monkeypatch, *args, **kw):
    """``sharded_read_all`` on the host path: the same files, rows and
    capacity, the record plans refused."""
    with monkeypatch.context() as m:
        m.setattr(ingest, "_record_plans", lambda *a: None)
        return ingest.sharded_read_all(*args, **kw)


def _same_batch(a, b):
    assert a.capacity == b.capacity and int(a.count) == int(b.count)
    assert list(a.data) == list(b.data) and a.policy == b.policy
    for name in b.data:
        x, y = a.data[name], b.data[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.numpy().tobytes() == y.numpy().tobytes(), name


def _staging(monkeypatch, nbytes):
    """The CPU's staging replaced, for the test, by one of ``nbytes``."""
    cpu = torch.device("cpu")
    monkeypatch.setitem(ingest._STAGING, cpu, ingest._Staging(cpu, nbytes))


def _formats(tmp_path):
    """Three format-6 files of unequal sizes (the sheet's schema), two
    format-1 files (28-byte records) and three format-0 files of unequal
    sizes (20-byte records), the last two read as positions and
    intensity."""
    sheet = [_sheet_file(tmp_path / f"s{i}.las", n, 10 + i,
                         (136000.0 + 1000 * i, 455000.0, 0.0))
             for i, n in enumerate((3001, 700, 4500))]
    rng = np.random.default_rng(7)
    schema = PointSchema.from_attributes([att.POSITION_3D, att.INTENSITY,
                                          att.GPS_TIME])
    f1 = []
    for i, n in enumerate((2500, 1999)):
        path = tmp_path / f"f1_{i}.las"
        write_all(HostPointBuffer.from_columns(schema, {
            POS: np.round(rng.uniform(0, 500, (n, 3)) + [85000, 446000, 0],
                          3),
            INT: rng.integers(0, 65536, n).astype(np.uint16),
            att.GPS_TIME.name: rng.uniform(0, 1e6, n)}), path)
        f1.append(str(path))
    pos_int = PointSchema.from_attributes([att.POSITION_3D, att.INTENSITY])
    f0 = []
    for i, n in enumerate((700, 130, 455)):
        path = tmp_path / f"f0_{i}.las"
        write_all(HostPointBuffer.from_columns(pos_int, {
            POS: np.round(rng.uniform(0, 50, (n, 3)), 3),
            INT: rng.integers(0, 4096, n).astype(np.uint16)}), path)
        f0.append(str(path))
    return {"format6": (sheet, SHEET_SCHEMA), "format1": (f1, pos_int),
            "format0": (f0, pos_int)}


@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("policy", ["NARROW", "EXACT"])
@pytest.mark.parametrize("fmt", ["format6", "format1", "format0"])
def test_record_path_equals_host_path(tmp_path, monkeypatch, fmt, policy,
                                      size):
    """Every rank of a mesh of ``size`` (a file straddled by two ranks),
    chunks that divide no shard and chunks larger than a file, capacity
    padded to 512 rows: the same batch as the host path, every row decoded
    once and all of them on the record path."""
    paths, schema = _formats(tmp_path)[fmt]
    with open_reader(paths[0]) as r:
        assert r.record_size == {"format6": 30, "format1": 28,
                                 "format0": 20}[fmt]
    pol = getattr(DevicePolicy, policy)
    total = 0
    for p in paths:
        with open_reader(p) as r:
            total += r.point_count()
    for chunk in (1 << 20, 37 * 30 + 5):
        _staging(monkeypatch, chunk)
        rows = 0
        for rank in range(size):
            mesh = Mesh(None, rank, size, torch.device("cpu"), "gloo")
            before = dict(ingest.POINTS_DECODED)
            got = ingest.sharded_read_all(paths, mesh, schema=schema,
                                          policy=pol, capacity_multiple=512)
            n = int(got.count)
            assert ingest.POINTS_DECODED["on_card"] \
                - before["on_card"] == n
            assert ingest.POINTS_DECODED["sharded_read_all"] \
                - before["sharded_read_all"] == n
            _same_batch(got, _host_path(monkeypatch, paths, mesh,
                                        schema=schema, policy=pol,
                                        capacity_multiple=512))
            rows += n
        assert rows == total


def test_staging_is_made_once_a_device(monkeypatch):
    """A device's staging is made at its first call, whole 16-byte words,
    and every later call gets the same."""
    monkeypatch.setattr(ingest, "_STAGING", {})
    cpu = torch.device("cpu")
    st = ingest._staging(cpu)
    assert st.nbytes == ingest.CHUNK_BYTES and st.nbytes % 16 == 0
    assert ingest._staging(cpu) is st and ingest._STAGING == {cpu: st}
    assert ingest._Staging(cpu, 997).nbytes == 1008


@pytest.mark.parametrize("policy", ["NARROW", "EXACT"])
def test_column_carrier_is_from_hosts(policy):
    """``column_carrier`` against ``PointBatch.from_host`` for every named
    dtype: the carrier is the column's dtype, and where it says the
    components ride unchanged, the column holds them, zero-extended."""
    pol = getattr(DevicePolicy, policy)
    rng = np.random.default_rng(4)
    for d in dt.ALL_NAMED_DTYPES:
        attr = att.PointAttribute("Field", d)
        wire = d.np_component_dtype
        shape = (64,) + d.np_shape
        if wire.kind == "f":
            host = rng.uniform(-1e6, 1e6, shape).astype(wire)
        else:
            info = np.iinfo(wire)
            host = rng.integers(info.min, info.max, shape, dtype=wire,
                                endpoint=True)
        buf = HostPointBuffer.from_columns(
            PointSchema.from_attributes([attr]), {"Field": host})
        col = PointBatch.from_host(buf, policy=pol, device="cpu").data[
            "Field"].numpy()[:64]
        carrier, unchanged = column_carrier(d, pol)
        assert col.dtype == carrier, d.name
        if unchanged:
            assert carrier.itemsize >= wire.itemsize
            np.testing.assert_array_equal(col, host.astype(carrier))
            assert (col >= 0).all() or wire.kind != "u", d.name



@pytest.mark.time_limit(120)
def test_record_path_shares_its_staging_between_threads(tmp_path,
                                                        monkeypatch):
    """Sixteen threads read at once through the one staging of the CPU, the
    interpreter switching threads every microsecond: every batch equals
    the host path's and no row goes uncounted."""
    import sys
    paths, schema = _formats(tmp_path)["format6"]
    _staging(monkeypatch, 41 * 30)
    meshes = [Mesh(None, r % 3, 3, torch.device("cpu"), "gloo")
              for r in range(16)]
    want = [_host_path(monkeypatch, paths, m, schema=schema)
            for m in meshes[:3]]
    before = ingest.POINTS_DECODED["on_card"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            got = list(ex.map(lambda m: ingest.sharded_read_all(
                paths, m, schema=schema, max_workers=2), meshes))
    finally:
        sys.setswitchinterval(interval)
    for i, batch in enumerate(got):
        _same_batch(batch, want[i % 3])
    assert ingest.POINTS_DECODED["on_card"] - before \
        == sum(int(b.count) for b in got)


@pytest.mark.parametrize("case", ["laz", "pnts", "flags", "default",
                                  "narrowed_gps"])
def test_host_path_for_laz_pnts_and_flags(tmp_path, monkeypatch, case):
    """LAZ and ``.pnts`` files, and LAS files read into a schema that
    needs the flags fanned out (named, or the file's default) or into a
    narrowed GPS time: the host path, ``POINTS_DECODED["on_card"]``
    unchanged, on every rank of two."""
    rng = np.random.default_rng(9)
    schema = PointSchema.from_attributes([att.POSITION_3D, att.INTENSITY])
    buf = HostPointBuffer.from_columns(schema, {
        POS: np.round(rng.uniform(0, 50, (300, 3)), 3),
        INT: rng.integers(0, 4096, 300).astype(np.uint16)})
    for ext in ("laz", "pnts", "las"):
        write_all(buf, tmp_path / f"a.{ext}")
    flags = PointSchema.from_attributes([att.POSITION_3D,
                                         att.RETURN_NUMBER])
    gps = PointSchema.from_attributes([att.POSITION_3D, att.GPS_TIME])
    f1 = _formats(tmp_path)["format1"][0]
    paths, sch = {"laz": ([tmp_path / "a.laz"], schema),
                  "pnts": ([tmp_path / "a.pnts"], None),
                  "flags": ([tmp_path / "a.las"], flags),
                  "default": ([tmp_path / "a.las"], None),
                  "narrowed_gps": (f1, gps)}[case]
    for rank in range(2):
        mesh = Mesh(None, rank, 2, torch.device("cpu"), "gloo")
        before = dict(ingest.POINTS_DECODED)
        got = ingest.sharded_read_all(paths, mesh, schema=sch)
        assert ingest.POINTS_DECODED["on_card"] == before["on_card"]
        assert ingest.POINTS_DECODED["sharded_read_all"] \
            > before["sharded_read_all"]
        _same_batch(got, _host_path(monkeypatch, paths, mesh, schema=sch))


# ---- on the card ------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K9 runs on the card only")


@pytest.mark.card
@pytest.mark.parametrize("case", ["sheet_shard", "odd_tail", "format1",
                                  "rd_new", "wide"])
def test_kernel_equals_plain_on_the_card(case):
    """K9 against its plain version on the card, bit for bit: a 15 M-row
    shard decoded in the record path's chunks (random bytes: every int32
    local), a chunk with an odd tail, 28-byte records (positions and
    intensity), the sheet's RD New locals (float32 rounding of every row
    matters) and a record with vector, float64 and widened fields."""
    _need_card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    name = "wide" if case == "wide" else (
        "format1" if case == "format1" else "format6")
    layout, pos_offset, names = LAYOUTS[name]
    rs = layout.itemsize
    n = {"sheet_shard": 15_000_000, "odd_tail": 1_000_003}.get(case, 400_001)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    nbytes = -(-n * rs // 16) * 16
    raw = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev,
                        generator=g)
    if case == "rd_new":
        rec = np.zeros(n, layout)
        rec["xyz"] = rng.integers(0, (2_000_000, 2_500_000, 60_000), (n, 3))
        raw[:n * rs] = torch.from_numpy(rec.view(np.uint8).copy()).to(dev)
    cap = n + 513
    want_pos = torch.zeros((cap, 3), device=dev)
    want = _fields(layout, names, cap, dev)
    k9.las_records_decode_plain(raw, n, rs, 0, SCALE, OFFSET, pos_offset,
                                want_pos, want)
    got_pos = torch.zeros((cap, 3), device=dev)
    got = _fields(layout, names, cap, dev)
    # the chunks start on 16-byte boundaries, as the staging's do
    per = ((32 << 20) // rs) & ~15 if case == "sheet_shard" else n
    before = k9.LAUNCHES["las_records_decode"]
    for a in range(0, n, per):
        m = min(per, n - a)
        k9.las_records_decode(raw[a * rs:], m, rs, a, SCALE, OFFSET,
                              pos_offset, got_pos, got)
    torch.cuda.synchronize()
    assert k9.LAUNCHES["las_records_decode"] == before + -(-n // per)
    assert torch.equal(_bits(got_pos), _bits(want_pos))
    for (_, _, g_col), (_, _, w_col) in zip(got, want):
        assert torch.equal(g_col.view(torch.uint8), w_col.view(torch.uint8))


@pytest.mark.card
def test_sharded_read_all_on_the_card_reuses_staging(tmp_path, monkeypatch):
    """Two files read on the card as one rank of two: the batch equals the
    host path's bit for bit, every row through K9; a second call reuses the
    pinned and device staging (the same buffers, no pinned allocation)."""
    _need_card()
    dev = torch.device("cuda")
    paths = [_sheet_file(tmp_path / f"c{i}.las", n, 20 + i)
             for i, n in enumerate((3_000_000, 2_500_001))]
    mesh = Mesh(None, 0, 2, dev, "nccl")
    kw = dict(schema=SHEET_SCHEMA, capacity_multiple=512)
    before = dict(ingest.POINTS_DECODED)
    first = ingest.sharded_read_all(paths, mesh, **kw)
    st = ingest._STAGING[dev]
    buffers = [t.data_ptr() for t in st.host + st.card]
    stats = getattr(torch.cuda, "host_memory_stats", lambda: {})
    allocs = stats().get("num_host_alloc")
    second = ingest.sharded_read_all(paths, mesh, **kw)
    torch.cuda.synchronize()
    assert ingest._STAGING[dev] is st
    assert [t.data_ptr() for t in st.host + st.card] == buffers
    assert stats().get("num_host_alloc") == allocs
    n = int(first.count)
    assert n == 2_750_001
    assert ingest.POINTS_DECODED["on_card"] - before["on_card"] == 2 * n
    host = _host_path(monkeypatch, paths, mesh, **kw)
    for batch in (first, second):
        assert batch.capacity == host.capacity
        assert int(batch.count) == int(host.count)
        for name, col in host.data.items():
            assert torch.equal(_bits(batch.data[name]), _bits(col)), name


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t
