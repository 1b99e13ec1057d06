"""The algorithm layer and the spatial sorts of pasture_tpu_torch against the
JAX package on the same numpy columns: ``voxelgrid_filter`` (host path
bit-equal, device path to f32 summation order), ``calculate_bounds``,
``minmax_attribute``, ``sort_by_keys``, ``morton_sort`` — the matching cases
of tests/test_algorithms.py and tests/test_ops.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu import algorithms as jalg
from pasture_tpu.buffers.device import PointBatch as JPointBatch
from pasture_tpu.buffers.host import HostPointBuffer as JHostPointBuffer
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.layout.dtypes import DevicePolicy as JDevicePolicy
from pasture_tpu.layout.schema import PointSchema as JPointSchema
from pasture_tpu.ops import morton_sort as j_morton_sort
from pasture_tpu.ops import voxel_indices as j_voxel_indices
from pasture_tpu.ops.sort import sort_by_keys as j_sort_by_keys

from pasture_tpu_torch import algorithms as alg
from pasture_tpu_torch.buffers import HostPointBuffer, PointBatch
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.dtypes import DevicePolicy
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.math import AABB
from pasture_tpu_torch.ops import morton_sort, sort_by_keys, voxel_indices

T = torch.from_numpy

NAMES = ("Position3D", "Intensity", "Classification", "ScanAngleRank",
         "ClassificationFlags", "GpsTime", "ColorRGB")


def _columns(rng, n, extent=10.0):
    return {
        "Position3D": rng.uniform(0, extent, (n, 3)),
        "Intensity": rng.integers(0, 1000, n).astype(np.uint16),
        "Classification": rng.integers(0, 4, n).astype(np.uint8),
        "ScanAngleRank": rng.integers(-3, 3, n).astype(np.int8),
        "ClassificationFlags": rng.integers(0, 16, n).astype(np.uint8),
        "GpsTime": rng.uniform(-5, 5, n),
        "ColorRGB": rng.integers(0, 65536, (n, 3)).astype(np.uint16),
    }


def _host_buffers(cols):
    """The same columns as a host buffer of each package."""
    names = [n for n in NAMES if n in cols]
    jschema = JPointSchema.from_attributes(
        [a for n in names for a in jatt.BUILTIN_ATTRIBUTES if a.name == n])
    pschema = PointSchema.from_attributes(
        [a for n in names for a in att.BUILTIN_ATTRIBUTES if a.name == n])
    return (JHostPointBuffer.from_columns(jschema, dict(cols)),
            HostPointBuffer.from_columns(pschema, dict(cols)))


def _batches(jhost, phost, cap):
    return (JPointBatch.from_host(jhost, policy=JDevicePolicy.EXACT,
                                  capacity=cap),
            PointBatch.from_host(phost, policy=DevicePolicy.EXACT,
                                 capacity=cap, device="cpu"))


# ---- voxelgrid_filter ----------------------------------------------------------

@pytest.mark.parametrize("leaf,policies", [
    ((1.0, None, None), None),
    ((1.5, 0.75, 2.0), None),
    ((1.0, None, None), {"Intensity": "max", "Classification": "mean",
                         "GpsTime": "mean"}),
])
def test_voxelgrid_filter_host_path_bit_equal(rng, leaf, policies):
    jhost, phost = _host_buffers(_columns(rng, 500))
    want = jalg.voxelgrid_filter(jhost, *leaf, policies=policies)
    got = alg.voxelgrid_filter(phost, *leaf, policies=policies)
    assert isinstance(got, HostPointBuffer)
    assert 0 < len(got) == len(want) < 500
    for name in NAMES:
        w, g = want.columns[name], got.columns[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


def test_voxelgrid_filter_host_reference_example():
    """Reference doc example: 100x100 grid, leaf 1.5 -> < half the points
    (voxel_grid.rs:86-108); and the edge cases of the host path."""
    ii, jj = np.meshgrid(np.arange(100.0), np.arange(100.0))
    pos = np.stack([np.zeros(10000), ii.ravel(), jj.ravel()], axis=1)
    jhost, phost = _host_buffers({"Position3D": pos})
    out = alg.voxelgrid_filter(phost, 1.5, 1.5, 1.5)
    want = jalg.voxelgrid_filter(jhost, 1.5, 1.5, 1.5)
    assert 0 < len(out) == len(want) < len(phost) / 2
    assert out.columns["Position3D"].tobytes() == \
        want.columns["Position3D"].tobytes()
    assert len(alg.voxelgrid_filter(phost.slice(0, 0), 1.0)) == 0
    _, no_pos = _host_buffers({"Intensity": np.zeros(4, np.uint16)})
    with pytest.raises(ValueError, match="Position3D"):
        alg.voxelgrid_filter(no_pos, 1.0)
    wave_schema = PointSchema.from_attributes(
        [att.POSITION_3D, att.WAVEFORM_PACKET_SIZE])
    wave = HostPointBuffer.from_columns(wave_schema, {
        "Position3D": pos[:4],
        att.WAVEFORM_PACKET_SIZE.name: np.zeros(4, np.uint32)})
    with pytest.raises(ValueError, match="waveform"):
        alg.voxelgrid_filter(wave, 1.0)
    with pytest.raises(ValueError, match="unknown policy"):
        alg.voxelgrid_filter(phost, 1.0, policies={"Position3D": "median"})


def test_voxelgrid_filter_device_path_matches_jax(rng):
    names = ("Position3D", "Intensity", "Classification", "GpsTime")
    cols = _columns(rng, 500)
    jhost, phost = _host_buffers({n: cols[n] for n in names})
    jb, pb = _batches(jhost, phost, 512)
    # under one jax.jit: eager, the device path dispatches op by op
    want = jax.jit(lambda b: jalg.voxelgrid_filter(b, 1.0))(jb)
    got = alg.voxelgrid_filter(pb, 1.0)
    assert isinstance(got, PointBatch)
    nv = int(want.count)
    assert int(got.count) == nv
    wh, gh = want.to_host(), got.to_host()
    for name in names:
        w, g = wh.columns[name], gh.columns[name]
        assert g.dtype == w.dtype, name
        if w.dtype.kind == "f":
            # f64 sums taken in another order
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # host and device paths find the same centroids (tests/test_algorithms.py
    # test_voxelgrid_host_vs_device_counts)
    host_out = alg.voxelgrid_filter(phost, 1.0)
    assert len(host_out) == nv
    np.testing.assert_allclose(
        np.sort(host_out.get("Position3D"), axis=0),
        np.sort(gh.get("Position3D"), axis=0), atol=1e-5)
    with pytest.raises(ValueError, match="cubic"):
        alg.voxelgrid_filter(pb, 1.0, 2.0, 1.0)


# ---- bounds / minmax -----------------------------------------------------------

def test_calculate_bounds_host_and_device(rng):
    cols = _columns(rng, 100)
    cols["Position3D"] = cols["Position3D"] - 5.0
    jhost, phost = _host_buffers(cols)
    jb, pb = _batches(jhost, phost, 128)
    for jbuf, pbuf in ((jhost, phost), (jb, pb)):
        want = jalg.calculate_bounds(jbuf)
        got = alg.calculate_bounds(pbuf)
        assert isinstance(got, AABB)
        np.testing.assert_array_equal(got.min, want.min)
        np.testing.assert_array_equal(got.max, want.max)
        assert got.min.dtype == np.float64
    np.testing.assert_array_equal(got.min, cols["Position3D"].min(axis=0))
    # empty clouds, and a missing position column
    assert alg.calculate_bounds(phost.slice(0, 0)) is None
    assert alg.calculate_bounds(pb.with_count(0)) is None
    _, no_pos = _host_buffers({"Intensity": np.zeros(4, np.uint16)})
    with pytest.raises(ValueError, match="Position3D"):
        alg.calculate_bounds(no_pos)
    with pytest.raises(ValueError, match="Position3D"):
        alg.calculate_bounds(PointBatch.from_host(no_pos, device="cpu"))
    # the AABB type is the reference's
    box = AABB.from_min_max([0, 0, 0], [1, 2, 3])
    assert box.contains([0.5, 1, 3]) and not box.contains([0.5, 1, 3.1])
    assert box.union(got).contains(got.center)
    np.testing.assert_array_equal(box.as_cubic().extent, [3.0, 3.0, 3.0])
    with pytest.raises(ValueError):
        AABB.from_min_max([1, 0, 0], [0, 1, 1])


@pytest.mark.parametrize("name", ["Intensity", "Position3D", "GpsTime",
                                  "ScanAngleRank", "ColorRGB"])
def test_minmax_attribute_host_and_device(rng, name):
    cols = _columns(rng, 50)
    cols["GpsTime"][7] = np.nan                 # NaN never wins
    jhost, phost = _host_buffers(cols)
    jb, pb = _batches(jhost, phost, 64)
    pattr = next(a for a in att.BUILTIN_ATTRIBUTES if a.name == name)
    jattr = next(a for a in jatt.BUILTIN_ATTRIBUTES if a.name == name)
    for jbuf, pbuf, ja, pa in ((jhost, phost, jattr, pattr),
                               (jb, pb, name, name)):
        wmn, wmx = jalg.minmax_attribute(jbuf, ja)
        gmn, gmx = alg.minmax_attribute(pbuf, pa)
        np.testing.assert_array_equal(np.asarray(gmn), np.asarray(wmn))
        np.testing.assert_array_equal(np.asarray(gmx), np.asarray(wmx))
        assert np.asarray(gmn).dtype == np.asarray(wmn).dtype
    assert alg.minmax_attribute(phost.slice(0, 0), pattr) is None
    assert alg.minmax_attribute(pb.with_count(0), name) is None
    with pytest.raises(KeyError):
        alg.minmax_attribute(pb, "NIR")


# ---- sorts ---------------------------------------------------------------------

def test_sort_by_keys_and_morton_sort_match_jax(rng):
    jhost, phost = _host_buffers(_columns(rng, 200))
    jb, pb = _batches(jhost, phost, 256)
    # two u32 keys with many ties; padded rows carry the maximal key
    k0 = rng.integers(0, 5, 256).astype(np.uint32)
    k1 = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    k0[200:] = 0xFFFFFFFF
    want_b, want_k, want_p = j_sort_by_keys(jb, jnp.asarray(k0),
                                            jnp.asarray(k1))
    got_b, got_k, got_p = sort_by_keys(pb, T(k0.astype(np.int64)),
                                       T(k1.astype(np.int64)))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    for g, w in zip(got_k, want_k):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))
    for name in NAMES:
        np.testing.assert_array_equal(got_b.data[name].numpy(),
                                      np.asarray(want_b.data[name]))
    assert int(got_b.count) == 200
    # a signed int32 key sorts signed
    ks = rng.integers(-50, 50, 256).astype(np.int32)
    _, (gk,), gp = sort_by_keys(pb, T(ks))
    _, (wk,), wp = j_sort_by_keys(jb, jnp.asarray(ks))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    with pytest.raises(ValueError):
        sort_by_keys(pb)

    # morton_sort on the voxel cells (tests/test_ops.py
    # test_morton_sort_groups_cells)
    bmin = np.zeros(3)
    jcells = j_voxel_indices(jb.data["Position3D"], jb.valid_mask(), 2.0,
                             jnp.asarray(bmin))
    pcells = voxel_indices(pb.data["Position3D"], pb.valid_mask(), 2.0,
                           T(bmin))
    np.testing.assert_array_equal(pcells.numpy(), np.asarray(jcells))
    wb, (whi, wlo), wperm = j_morton_sort(jb, jcells)
    gb, (ghi, glo), gperm = morton_sort(pb, pcells)
    np.testing.assert_array_equal(gperm.numpy(), np.asarray(wperm))
    np.testing.assert_array_equal(ghi.numpy().astype(np.uint32),
                                  np.asarray(whi))
    np.testing.assert_array_equal(glo.numpy().astype(np.uint32),
                                  np.asarray(wlo))
    keys = (ghi.numpy().astype(np.uint64) << np.uint64(32)) \
        | glo.numpy().astype(np.uint64)
    assert np.all(keys[:-1] <= keys[1:])
    np.testing.assert_array_equal(gb.data["Position3D"].numpy(),
                                  np.asarray(wb.data["Position3D"]))
