"""Voxel downsampling of pasture_tpu_torch against the JAX package on the
same numpy inputs (CPU): the generic path, the reduce kernel's plain version
against the Pallas kernel in interpret mode, and the exact transform +
voxelize slice as a whole."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pasture_tpu.buffers.device as jdev
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.layout.schema import PointSchema as JPointSchema
from pasture_tpu.ops import voxel as jvoxel
from pasture_tpu.ops.kernels import fused_transform as jft
from pasture_tpu.ops.kernels import voxel_reduce_kernel as jvr

import chip_smoke
from pasture_tpu_torch import interop
from pasture_tpu_torch.buffers import PointBatch
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.ops import voxel_downsample
from pasture_tpu_torch.ops.kernels import voxel_reduce_kernel as vr

T = torch.from_numpy

POS, INT, CLS = "Position3D", "Intensity", "Classification"


def _jax_batch(columns, count, names):
    schema = JPointSchema.from_attributes(
        [a for n in names for a in jatt.BUILTIN_ATTRIBUTES if a.name == n])
    return jdev.PointBatch({k: jnp.asarray(v) for k, v in columns.items()},
                           jnp.asarray(count, jnp.int32), schema, {})


def _port_batch(jbatch, names):
    return interop.batch_from_reference_arrays(
        {k: np.asarray(v) for k, v in jbatch.data.items()},
        int(jbatch.count), names, device="cpu")


def _assert_batches_agree(want, got, float_tol):
    """count and integer columns exact; float columns to ``float_tol``."""
    nv = int(want.count)
    assert int(got.count) == nv and nv > 0
    cols, count, _, _ = interop.batch_to_reference_arrays(got)
    assert count == nv and set(cols) == set(want.data)
    for name, w in want.data.items():
        w = np.asarray(w)[:nv]
        g = cols[name][:nv]
        assert g.dtype == w.dtype, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=name, **float_tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    return nv


# ---- the generic path --------------------------------------------------------

NAMES = (POS, INT, CLS, "ScanAngleRank", "UserData", "ClassificationFlags",
         "GpsTime", "ColorRGB")


def _generic_columns(rng, n, mode_first):
    cols = {
        POS: rng.uniform(0, 32, (n, 3)).astype(np.float32),
        INT: rng.integers(0, 65536, n).astype(np.uint16),
        "ColorRGB": rng.integers(0, 65536, (n, 3)).astype(np.uint16),
        "ClassificationFlags": rng.integers(0, 16, n).astype(np.uint8),
        "GpsTime": rng.uniform(0, 1e5, n).astype(np.float32),
    }
    modes = {
        CLS: rng.integers(0, 6, n).astype(np.uint8),
        "ScanAngleRank": rng.integers(-3, 3, n).astype(np.int8),
        "UserData": rng.integers(0, 4, n).astype(np.uint8),
    }
    # the first integer mode column rides the top of the packed word
    cols[mode_first] = modes.pop(mode_first)
    cols.update(modes)
    return cols


@pytest.mark.parametrize("semantics,grid_bits,mode_first,sort_tiles", [
    ("floor", 10, CLS, 1),
    ("nearest", 20, "ScanAngleRank", 1),      # signed fused mode column
    ("floor", 20, "ScanAngleRank", 4),
    ("nearest", 10, CLS, 4),
])
def test_generic_voxel_downsample_matches_jax(rng, semantics, grid_bits,
                                              mode_first, sort_tiles):
    n = 4096
    cols = _generic_columns(rng, n, mode_first)
    if sort_tiles > 1:      # spatially disjoint x slabs: tiled == global
        per = n // sort_tiles
        for i in range(sort_tiles):
            cols[POS][i * per:(i + 1) * per, 0] = \
                rng.uniform(8 * i, 8 * i + 8, per).astype(np.float32)
    jbatch = _jax_batch(cols, n - 300, NAMES)        # an invalid tail
    pbatch = _port_batch(jbatch, NAMES)
    kw = dict(semantics=semantics, grid_bits=grid_bits,
              sort_tiles=sort_tiles)
    bounds = np.zeros(3, np.float32)
    want = jvoxel.voxel_downsample(jbatch, 2.0,
                                   bounds=(jnp.asarray(bounds), None), **kw)
    got = voxel_downsample(pbatch, 2.0, bounds=(T(bounds), None), **kw)
    # f32 sums taken in another order: a few ulp of values below 1e5
    nv = _assert_batches_agree(want, got, dict(rtol=1e-6, atol=2e-5))
    assert nv < n - 300                       # voxels do merge points
    assert not got.data[POS][nv:].any()       # rows past count are zero
    # data-driven bounds
    want = jvoxel.voxel_downsample(jbatch, 2.0, **kw)
    got = voxel_downsample(pbatch, 2.0, **kw)
    _assert_batches_agree(want, got, dict(rtol=1e-6, atol=2e-5))


def test_voxel_downsample_argument_errors(rng):
    n = 64
    cols = {POS: rng.uniform(0, 8, (n, 3)).astype(np.float32),
            CLS: rng.integers(0, 6, n).astype(np.uint8)}
    jb = _jax_batch(cols, n, (POS, CLS))
    pb = _port_batch(jb, (POS, CLS))
    keys = torch.zeros(n, dtype=torch.int64)
    zero = torch.zeros(3)
    bad = [
        dict(local_affine=(zero, torch.eye(3), zero, None)),
        dict(precomputed=(keys, keys), grid_bits=20, bounds=(zero, None)),
        dict(precomputed=(keys, keys), grid_bits=10, bounds=(zero, None)),
        dict(precomputed=(keys, None), grid_bits=10),
        dict(mode_runs=True),
        dict(semantics="round"),
        dict(sort_tiles=3),
        dict(policies={POS: "mode"}),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            voxel_downsample(pb, 1.0, **kw)
    with pytest.raises(ValueError, match="no 'Position3D'"):
        voxel_downsample(PointBatch({CLS: pb.data[CLS]}, pb.count,
                                    pb.schema), 1.0)
    # the same calls are errors in the JAX package
    for kw in (dict(mode_runs=True),
               dict(precomputed=(jnp.zeros(n, jnp.uint32), None),
                    grid_bits=10)):
        with pytest.raises(ValueError):
            jvoxel.voxel_downsample(jb, 1.0, **kw)
    # waveform attributes are rejected (voxel_grid.rs:452-459 parity)
    wf = att.WAVEFORM_PACKET_SIZE.name
    with pytest.raises(ValueError, match="waveform"):
        voxel_downsample(pb.with_column(wf, keys), 1.0)
    with pytest.raises(ValueError, match="waveform"):
        jvoxel.voxel_downsample(
            jb.with_column(wf, jnp.zeros(n, jnp.uint32)), 1.0)
    # later slices
    for kw in (dict(with_aux=True), dict(with_aux=True, mode_runs=True),
               dict(position_quantization_bits=10),
               dict(precomputed=(keys, None), grid_bits=10,
                    bounds=(zero, None))):
        with pytest.raises(NotImplementedError, match="slice"):
            voxel_downsample(pb, 1.0, **kw)


# ---- exact-local inputs --------------------------------------------------------

def _off_face_tiles(rng, tiles, per, leaf=chip_smoke.LEAF, margin=1e-3):
    """``tiles`` z-slab tiles of ``per`` i32 locals whose world image keeps
    ``margin`` leaves away from every cell face of the step's grid (f64
    check), so a fused multiply-add on one side and separately rounded
    operations on the other floor to the same cell.  The grid's y anchor is
    the data minimum: one anchor point holds it (its own cell is 0 by the
    clip at 0, whichever way its coordinate rounds)."""
    rot = chip_smoke.ROT.astype(np.float64)
    trans = chip_smoke.TRANS

    def to_local(w):
        return np.round(((w - trans) @ rot) / 0.001).astype(np.int32)

    def to_world(loc):
        return (loc.astype(np.float64) * 0.001) @ rot.T + trans

    anchor = to_local(np.asarray([[100.1, -45.0, trans[2] + 0.25]]))
    y0 = to_world(anchor)[0, 1]
    parts = []
    for i in range(tiles):
        m = 3 * per
        w = np.stack([rng.uniform(60.0, 140.0, m), rng.uniform(-40, 40, m),
                      trans[2] + (i * 500 + rng.uniform(5, 495, m)) * 0.001],
                     axis=1)
        loc = to_local(w)
        u = (to_world(loc) - np.asarray([0.0, y0, trans[2]])) / leaf
        frac = u - np.floor(u)
        ok = np.all((frac > margin) & (frac < 1 - margin), axis=1)
        loc = loc[ok][:per]
        assert len(loc) == per
        parts.append(loc)
    parts[0][0] = anchor[0]
    return np.concatenate(parts)


def _jax_head(local, leaf, semantics, bmin=None):
    """The JAX package's pipeline head, Pallas kernels in interpret mode."""
    scale = jnp.asarray(chip_smoke.SCALE)
    rot = jnp.asarray(chip_smoke.ROT)
    t = jnp.asarray(chip_smoke.TRANS, jnp.float32)
    loc = jnp.asarray(local)
    if bmin is None:
        wmin, _ = jft.fused_world_bounds(loc, scale, rot, t, interpret=True)
        bmin = jnp.stack([jnp.floor(wmin[0] / leaf) * leaf, wmin[1], t[2]])
    coeffs = jft.exact_local_base_coeffs(scale, rot, t, bmin, leaf,
                                         semantics)
    keys, rword = jft.fused_voxel_head_exact_local(
        loc, scale, rot, t, bmin, leaf, coeffs, semantics=semantics,
        interpret=True)
    return bmin, keys, rword, (scale, rot, t, coeffs)


# ---- K3: plain version against the Pallas kernel ------------------------------

def test_voxel_reduce_plain_matches_pallas_interpret(rng):
    semantics, leaf = "floor", chip_smoke.LEAF
    n, tiles = jvr.REDUCE_BLOCK, 128          # one 65 536-row block
    tile_len = n // tiles
    local = _off_face_tiles(rng, tiles, tile_len)
    bmin, keys, rword, affine = _jax_head(local, leaf, semantics)
    keys = np.asarray(keys).copy()
    keys[n - 700:] = 0xFFFFFFFF               # invalid tail in the last tiles
    cls = rng.integers(0, 5, n).astype(np.uint32)
    inten = rng.integers(0, 65536, n).astype(np.uint32)
    sar = rng.integers(-128, 128, n).astype(np.int64)       # signed i8 mean
    word = (cls << 24) | (inten << 8) | (sar & 0xFF).astype(np.uint32)
    fields = ((8, 16, False, 0, 65535), (0, 8, True, -128, 127))
    # tile sort by (key, word)
    order = np.concatenate([
        i * tile_len + np.lexsort((word[i * tile_len:(i + 1) * tile_len],
                                   keys[i * tile_len:(i + 1) * tile_len]))
        for i in range(tiles)])
    skey, sword, srw = keys[order], word[order], np.asarray(rword)[order]

    (wx, wy, wz, wword), wcounts = jvr.fused_sorted_voxel_reduce(
        jnp.asarray(skey), jnp.asarray(sword), jnp.asarray(srw), bmin, leaf,
        8, fields, 10, 1.0, tile_len, semantics, interpret=True,
        local_affine=affine)
    nv = int(np.asarray(wcounts)[0])

    paffine = interop.affine_from_reference(*affine, device="cpu")
    before = dict(vr.LAUNCHES)
    px, py, pz, pword, count = vr.fused_sorted_voxel_reduce(
        T(skey.astype(np.int64)), T(sword.astype(np.int64)),
        T(srw.astype(np.int64)), T(np.asarray(bmin)), leaf, 8, fields, 10,
        1.0, tile_len, semantics, local_affine=paffine)
    assert vr.LAUNCHES == before              # CPU tensors launch nothing
    assert int(count) == nv and 0 < nv < n - 700
    np.testing.assert_array_equal(pword.numpy()[:nv].astype(np.uint32),
                                  np.asarray(wword)[:nv])
    # the same f32 operations on exact integer sums; XLA on the CPU may fuse
    # a multiply-add where the port rounds each operation: a few ulp of
    # coordinates ~150
    for g, w in ((px, wx), (py, wy), (pz, wz)):
        np.testing.assert_allclose(g.numpy()[:nv], np.asarray(w)[:nv],
                                   rtol=0, atol=1e-4)
        assert not g.numpy()[nv:].any()       # rows past the count are zero
    assert not pword.numpy()[nv:].any()
    with pytest.raises(NotImplementedError, match="slice"):
        vr.fused_sorted_voxel_reduce(
            T(skey.astype(np.int64)), T(sword.astype(np.int64)),
            T(srw.astype(np.int64)), T(np.asarray(bmin)), leaf, 8, fields,
            10, 1.0, tile_len, semantics)


# ---- the slice as a whole -------------------------------------------------------

def test_exact_transform_voxelize_slice_matches_jax(rng):
    """The exact transform + voxelize step at 32 768 points in 64 z-slab
    tiles through both packages: the JAX package with its Pallas head in
    interpret mode and its generic reduce, the port through the functions
    its GPU smoke script drives."""
    n, tiles = 32768, 64
    local = _off_face_tiles(rng, tiles, n // tiles)
    inten = rng.integers(0, 65536, n).astype(np.uint16)
    cls = rng.integers(0, 32, n).astype(np.uint8)

    bmin, keys, rword, affine = _jax_head(local, chip_smoke.LEAF, "floor")
    jb = _jax_batch({INT: inten, CLS: cls}, n, (POS, INT, CLS))
    jvoxel._FORCE_FUSED_REDUCE = False
    try:
        want = jvoxel.voxel_downsample(
            jb, chip_smoke.LEAF, bounds=(bmin, None), semantics="floor",
            grid_bits=10, sort_tiles=tiles, precomputed=(keys, rword),
            local_affine=affine)
    finally:
        jvoxel._FORCE_FUSED_REDUCE = None

    batch = chip_smoke.make_batch(local, inten, cls, device="cpu")
    paffine = chip_smoke.affine_on("cpu")
    head = chip_smoke.pipeline_head(batch, paffine)
    np.testing.assert_array_equal(head[1].numpy().astype(np.uint32),
                                  np.asarray(keys))
    np.testing.assert_array_equal(head[2].numpy().astype(np.uint32),
                                  np.asarray(rword))
    got = chip_smoke.pipeline_batch(batch, paffine, tiles)
    # tests/test_pallas_kernels.py holds the same path to 2e-4
    nv = _assert_batches_agree(want, got, dict(rtol=0, atol=2e-4))

    # the port's generic path (plain PyTorch, no kernel wrappers) agrees
    # with its fast path: same integer sums, same f32 operations
    ref = chip_smoke.pipeline_voxelize(batch, head, tiles, fused=False)
    assert int(ref.count) == nv
    for name in (INT, CLS):
        assert torch.equal(ref.data[name][:nv], got.data[name][:nv])
    np.testing.assert_allclose(ref.data[POS][:nv].numpy(),
                               got.data[POS][:nv].numpy(), rtol=0, atol=1e-5)

    # f64 oracle over every (tile, voxel) group
    oracle = chip_smoke.f64_oracle(local, head[1].numpy(), n // tiles)
    assert oracle.shape[0] == nv
    err = np.linalg.norm(got.data[POS][:nv].numpy() - oracle, axis=1).max()
    assert err < 5e-4

