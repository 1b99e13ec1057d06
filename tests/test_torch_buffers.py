"""pasture_tpu_torch buffers, dtype carriers, casts and interop, held
against the JAX package on the same numpy inputs (CPU)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pasture_tpu.buffers as jbuf
import pasture_tpu.layout as jlay
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.ops.compact import compact_columns as j_compact_columns
from pasture_tpu.ops.convert import rust_as_cast_device as j_rust_as_cast
from pasture_tpu.ops.reductions import batch_bounds as j_batch_bounds
from pasture_tpu.ops.transform import (decode_las_positions as j_decode,
                                       transform_positions as j_transform)

import pasture_tpu_torch as ptt
from pasture_tpu_torch import interop
from pasture_tpu_torch.buffers import HostPointBuffer, PointBatch
from pasture_tpu_torch.layout import (DevicePolicy, PointSchema,
                                      attributes as att, dtypes as dt)
from pasture_tpu_torch.ops import (batch_bounds, compact_columns,
                                   decode_las_positions, rust_as_cast_device,
                                   transform_positions, u32_bits, u32_carrier)

ROOT = pathlib.Path(__file__).resolve().parents[1]

ATTRS = ("Position3D", "Intensity", "Classification", "ScanAngleRank",
         "ScanAngle", "GpsTime", "PointID", "WaveformPacketSize")


def _columns(rng, n):
    return {
        "Position3D": rng.uniform(-100, 100, (n, 3)),
        "Intensity": rng.integers(0, 2**16, n, dtype=np.uint16),
        "Classification": rng.integers(0, 255, n, dtype=np.uint8),
        "ScanAngleRank": rng.integers(-128, 128, n).astype(np.int8),
        "ScanAngle": rng.integers(-30000, 30000, n).astype(np.int16),
        "GpsTime": rng.uniform(0, 1e9, n),
        "PointID": rng.integers(0, 2**63, n).astype(np.uint64) * 2 + 1,
        "WaveformPacketSize": rng.integers(0, 2**32, n, dtype=np.uint32),
    }


def _both_buffers(rng, n=37):
    cols = _columns(rng, n)
    pschema = PointSchema.from_attributes(
        [getattr(att, _const(a)) for a in ATTRS])
    jschema = jlay.PointSchema.from_attributes(
        [getattr(jatt, _const(a)) for a in ATTRS])
    return (HostPointBuffer.from_columns(pschema, cols),
            jbuf.HostPointBuffer.from_columns(jschema, cols))


def _const(name):
    return {"Position3D": "POSITION_3D", "Intensity": "INTENSITY",
            "Classification": "CLASSIFICATION",
            "ScanAngleRank": "SCAN_ANGLE_RANK", "ScanAngle": "SCAN_ANGLE",
            "GpsTime": "GPS_TIME", "PointID": "POINT_ID",
            "WaveformPacketSize": "WAVEFORM_PACKET_SIZE"}[name]


CARRIERS = [
    (dt.U8, torch.uint8, torch.uint8), (dt.I8, torch.int8, torch.int8),
    (dt.I16, torch.int16, torch.int16), (dt.U16, torch.int32, torch.int32),
    (dt.I32, torch.int32, torch.int32), (dt.U32, torch.int64, torch.int64),
    (dt.F32, torch.float32, torch.float32),
    (dt.F64, torch.float32, torch.float64),
    (dt.I64, torch.int32, torch.int64), (dt.U64, torch.int64, torch.int64),
    (dt.VEC3F64, torch.float32, torch.float64),
    (dt.VEC3U16, torch.int32, torch.int32),
    (dt.byte_array(5), torch.uint8, torch.uint8),
]


@pytest.mark.parametrize("d,narrow,exact", CARRIERS,
                         ids=[c[0].name for c in CARRIERS])
def test_carrier_table(d, narrow, exact):
    assert DevicePolicy.NARROW.torch_dtype(d) == narrow
    assert DevicePolicy.EXACT.torch_dtype(d) == exact


@pytest.mark.parametrize("policy", ["NARROW", "EXACT"])
def test_from_host_to_host_equals_jax_package(rng, policy):
    pbuf, jb = _both_buffers(rng)
    got = PointBatch.from_host(pbuf, getattr(DevicePolicy, policy),
                               device="cpu")
    want = jbuf.PointBatch.from_host(jb, getattr(jlay.DevicePolicy, policy))
    assert got.capacity == want.capacity == 40
    assert int(got.count) == int(want.count) == 37
    # the device values agree column by column (logical dtype restored)...
    for name in ATTRS:
        w = np.asarray(want.data[name])
        g = got.data[name].numpy().astype(got.logical_dtype(name))
        assert got.logical_dtype(name) == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # ...and so does the round trip to the host
    gh, wh = got.to_host(), want.to_host()
    for name in ATTRS:
        assert gh.columns[name].dtype == wh.columns[name].dtype
        np.testing.assert_array_equal(gh.columns[name], wh.columns[name],
                                      err_msg=name)


def test_batch_methods(rng):
    pbuf, _ = _both_buffers(rng, 12)
    b = PointBatch.from_host(pbuf, device="cpu", capacity=16)
    assert b.valid_mask().tolist() == [True] * 12 + [False] * 4
    assert len(b.pad_to(24)) == 24 and int(b.pad_to(24).count) == 12
    with pytest.raises(ValueError):
        b.pad_to(8)
    with pytest.raises(ValueError):
        PointBatch.from_host(pbuf, device="cpu", capacity=4)
    g = b.gather(torch.tensor([3, 1]), count=2)
    assert g.data["Intensity"].tolist() == \
        [int(pbuf.columns["Intensity"][i]) for i in (3, 1)]
    assert int(b.with_count(5).count) == 5
    assert b.with_column("X", torch.zeros(16)).data["X"].shape == (16,)
    assert b.count.dtype == torch.int32 and b.count.ndim == 0


def test_device_none_raises_without_cuda(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pbuf, _ = _both_buffers(rng, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        PointBatch.from_host(pbuf)
    with pytest.raises(RuntimeError, match="cuda"):
        PointBatch.from_columns(pbuf.schema, {"Intensity": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="cuda"):
        interop.batch_from_reference_arrays({}, 0, ())
    with pytest.raises(RuntimeError, match="cuda"):
        interop.affine_from_reference(np.ones(3), np.eye(3), np.zeros(3),
                                      np.zeros(15))


def test_interop_round_trip(rng):
    _, jb = _both_buffers(rng, 21)
    jbatch = jbuf.PointBatch.from_host(jb)
    jbatch = jbatch.with_column(
        "LASLocalPosition",
        jnp.asarray(rng.integers(-2**31, 2**31, (24, 3)).astype(np.int32)))
    cols = {k: np.asarray(v) for k, v in jbatch.data.items()}
    b = interop.batch_from_reference_arrays(
        cols, int(jbatch.count), jbatch.schema.names, device="cpu")
    assert b.schema.names == jbatch.schema.names
    assert [m.dtype.name for m in b.schema.members] == \
        [m.dtype.name for m in jbatch.schema.members]
    back, count, names, _ = interop.batch_to_reference_arrays(b)
    assert count == 21 and names == jbatch.schema.names
    assert set(back) == set(cols)
    for k in cols:
        assert back[k].dtype == cols[k].dtype, k
        np.testing.assert_array_equal(back[k], cols[k], err_msg=k)
    aff = interop.affine_from_reference(
        np.ones(3), np.eye(3), np.zeros(3), np.arange(15), device="cpu")
    assert [t.dtype for t in aff] == [torch.float32] * 3 + [torch.int32]


def test_u32_word_forms(rng):
    v = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    carrier = torch.from_numpy(v.astype(np.int64))
    bits = u32_bits(carrier)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), v)
    assert torch.equal(u32_carrier(bits), carrier)
    with pytest.raises(TypeError):
        u32_carrier(torch.zeros(3))


@pytest.mark.parametrize("dst", [np.int8, np.uint8, np.int16, np.uint16,
                                 np.int32, np.uint32, np.float32])
def test_rust_as_cast_matches_jax(rng, dst):
    f = np.concatenate([rng.uniform(-7e4, 7e4, 200),
                        [np.nan, np.inf, -np.inf, 3e9, -3e9, 1e12, -0.5,
                         255.9, 65535.5]]).astype(np.float32)
    i = rng.integers(-2**31, 2**31, 200).astype(np.int32)
    for src in (f, i):
        want = np.asarray(j_rust_as_cast(jnp.asarray(src), dst))
        got = rust_as_cast_device(torch.from_numpy(src), dst)
        assert got.dtype == dt.torch_carrier(dst)
        np.testing.assert_array_equal(got.numpy().astype(dst), want)


def test_transform_bounds_compact_match_jax(rng):
    n = 1000
    local = rng.integers(-50_000, 150_000, (n, 3)).astype(np.int32)
    scale = np.asarray([0.001, 0.002, 0.0005], np.float32)
    offset = np.asarray([3.0, -1.0, 0.25], np.float32)
    th = 0.7
    rot = np.asarray([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    trans = np.asarray([3.0, -8.0, 0.5], np.float32)
    T = torch.from_numpy
    for anchor in (None, local.min(0)):
        want = np.asarray(j_decode(
            jnp.asarray(local), jnp.asarray(scale), jnp.asarray(offset),
            None if anchor is None else jnp.asarray(anchor)))
        got = decode_las_positions(
            T(local), T(scale), T(offset),
            None if anchor is None else T(anchor))
        np.testing.assert_array_equal(got.numpy(), want)
    pos = got
    # the port writes the 3x3 product as explicit f32 sums; XLA's dot may
    # fuse multiply-adds: one f32 rounding of values up to ~200
    want = np.asarray(j_transform(jnp.asarray(pos.numpy()), jnp.asarray(rot),
                                  jnp.asarray(trans)))
    np.testing.assert_allclose(
        transform_positions(pos, T(rot), T(trans)).numpy(), want,
        rtol=1e-6, atol=2e-5)

    mask = np.arange(n) < 900
    p = pos.numpy().copy()
    p[5, 1] = np.nan
    wmin, wmax = j_batch_bounds(jnp.asarray(p), jnp.asarray(mask))
    gmin, gmax = batch_bounds(T(p), T(mask))
    np.testing.assert_array_equal(gmin.numpy(), np.asarray(wmin))
    np.testing.assert_array_equal(gmax.numpy(), np.asarray(wmax))

    keep = rng.random(n) < 0.6
    a = rng.integers(0, 1000, n).astype(np.int32)
    f = rng.random(n).astype(np.float32)
    (wa, wf), wc = j_compact_columns([jnp.asarray(a), jnp.asarray(f)],
                                     jnp.asarray(keep))
    (ga, gf), gc = compact_columns([T(a), T(f)], T(keep))
    k = int(wc)
    assert int(gc) == k == keep.sum()
    np.testing.assert_array_equal(ga.numpy()[:k], np.asarray(wa)[:k])
    np.testing.assert_array_equal(gf.numpy()[:k], np.asarray(wf)[:k])
    assert not ga[k:].any() and not gf[k:].any()


def test_port_imports_nothing_of_jax_or_the_jax_package():
    needles = ("import jax", "from jax", "pasture_tpu.", "from pasture_tpu ",
               "import pasture_tpu\n", "import pasture_tpu ")
    files = sorted((ROOT / "pasture_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    hits = []
    for path in files:
        text = path.read_text()
        hits += [(str(path.relative_to(ROOT)), n) for n in needles
                 if n in text]
    assert not hits, hits


def test_import_needs_no_toolchain():
    """Importing every module of the port builds nothing and needs no GPU."""
    import importlib
    import pkgutil
    names = [m.name for m in pkgutil.walk_packages(
        ptt.__path__, prefix="pasture_tpu_torch.")]
    assert "pasture_tpu_torch.ops.kernels._build" in names
    for name in names:
        importlib.import_module(name)
    from pasture_tpu_torch.ops.kernels import _build
    assert not _build._libs
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == \
        sorted(_build.SOURCES)
