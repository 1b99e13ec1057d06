"""Voxel downsampling of pasture_tpu_torch against the JAX package on the
same numpy inputs (CPU): the generic path, the reduce kernel's plain version
against the Pallas kernel in interpret mode (all three position forms), the
quantized and the exact-f32 paths with and without precomputed keys, and
the exact transform + voxelize slice as a whole."""

import jax
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
from pasture_tpu_torch.ops.kernels import fused_transform as ft
from pasture_tpu_torch.ops.kernels import voxel_reduce_kernel as vr

T = torch.from_numpy

POS, INT, CLS = "Position3D", "Intensity", "Classification"


def _jax_batch(columns, count, names):
    schema = JPointSchema.from_attributes(
        [a for n in names for a in jatt.BUILTIN_ATTRIBUTES if a.name == n])
    return jdev.PointBatch({k: jnp.asarray(v) for k, v in columns.items()},
                           jnp.asarray(count, jnp.int32), schema, {})


def _jax_voxel(jbatch, leaf, **kw):
    """The JAX package's ``voxel_downsample`` under one ``jax.jit`` (eager,
    it dispatches op by op)."""
    return jax.jit(lambda b: jvoxel.voxel_downsample(b, leaf, **kw))(jbatch)


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
    want = _jax_voxel(jbatch, 2.0, bounds=(jnp.asarray(bounds), None), **kw)
    got = voxel_downsample(pbatch, 2.0, bounds=(T(bounds), None), **kw)
    # f32 sums taken in another order: a few ulp of values below 1e5
    nv = _assert_batches_agree(want, got, dict(rtol=1e-6, atol=2e-5))
    assert nv < n - 300                       # voxels do merge points
    assert not got.data[POS][nv:].any()       # rows past count are zero
    # data-driven bounds
    want = _jax_voxel(jbatch, 2.0, **kw)
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
    # with the merge statistics (ported with the file -> map slice) the
    # call returns a (batch, aux) pair
    for kw in (dict(with_aux=True), dict(with_aux=True, mode_runs=True)):
        out, aux = voxel_downsample(pb, 1.0, **kw)
        assert int(out.count) == int((aux["counts"] > 0).sum()) > 0
        assert ("mode_runs" in aux) == ("mode_runs" in kw)
    # the quantized and the exact-f32 precomputed paths no longer refuse
    for kw in (dict(position_quantization_bits=10),
               dict(precomputed=(keys, None), grid_bits=10,
                    bounds=(zero, None))):
        assert int(voxel_downsample(pb, 1.0, **kw).count) > 0


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
    # the position operands come in exactly one form
    streams = (T(skey.astype(np.int64)), T(sword.astype(np.int64)),
               T(srw.astype(np.int64)))
    tail = (T(np.asarray(bmin)), leaf, 8, fields, 10, 1.0, tile_len,
            semantics)
    f = torch.zeros(n)
    for kw in (dict(spos=(f, f, f)),
               dict(spos=(f, f, f), local_affine=paffine)):
        with pytest.raises(ValueError, match="sqword"):
            vr.fused_sorted_voxel_reduce(*streams, *tail, **kw)
    with pytest.raises(ValueError, match="sqword"):
        vr.fused_sorted_voxel_reduce(*streams[:2], None, *tail)
    with pytest.raises(ValueError, match="qbits"):
        vr.fused_sorted_voxel_reduce(*streams, *tail[:4], 11, *tail[5:])


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
        want = _jax_voxel(
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



# ---- the quantized and the exact-f32 paths ------------------------------------

def _slab_columns(rng, n, tiles):
    """Positions in ``tiles`` spatially disjoint x slabs (tiled == global),
    a u16 mean column and a u8 mode column."""
    per = n // tiles
    pos = np.concatenate([np.stack([
        rng.uniform(4 * i, 4 * i + 4, per), rng.uniform(0, 64, per),
        rng.uniform(0, 64, per)], axis=1) for i in range(tiles)]
    ).astype(np.float32)
    return {POS: pos, INT: rng.integers(0, 65536, n).astype(np.uint16),
            CLS: rng.integers(0, 32, n).astype(np.uint8)}


def _jax_forced(fused, fn):
    jvoxel._FORCE_FUSED_REDUCE = fused
    try:
        return fn()
    finally:
        jvoxel._FORCE_FUSED_REDUCE = None


SLAB_NAMES = (POS, INT, CLS)
ZERO3 = np.zeros(3, np.float32)


@pytest.mark.parametrize("semantics,qbits", [("floor", 10), ("nearest", 10),
                                             ("floor", 8), (None, None)])
def test_fast_paths_match_jax_generic_path(rng, semantics, qbits):
    """The quantized path (internal quantizer) and, with ``qbits`` None, the
    exact-f32 path, 8192 points in 4 tiles: the port's fast path (plain
    versions of tile_sort and the reduce kernel) and its generic path,
    each against the JAX package's generic path."""
    n, tiles = 8192, 4
    exact = qbits is None
    semantics = semantics or "floor"
    jb = _jax_batch(_slab_columns(rng, n, tiles), n - 300, SLAB_NAMES)
    pb = _port_batch(jb, SLAB_NAMES)
    kw = dict(semantics=semantics, grid_bits=10, sort_tiles=tiles,
              position_quantization_bits=qbits)
    want = _jax_forced(False, lambda: _jax_voxel(
        jb, 2.0, bounds=(jnp.asarray(ZERO3), None), **kw))
    # tests/test_pallas_kernels.py holds the JAX package's own two paths to
    # these bounds: atol 2e-5 (quantized), 1e-4 (f32 sums in another order)
    tol = dict(rtol=1e-6, atol=1e-4 if exact else 2e-5)
    outs = {}
    for fused in (True, False):
        got = voxel_downsample(pb, 2.0, bounds=(T(ZERO3), None), fused=fused,
                               **kw)
        nv = _assert_batches_agree(want, got, tol)
        assert not got.data[POS][nv:].any()
        outs[fused] = got
    # the two paths of the port: integer columns equal, centroids equal for
    # the quantized form (exact integer sums, the same f32 operations)
    for name in (INT, CLS):
        assert torch.equal(outs[True].data[name], outs[False].data[name])
    if not exact:
        assert torch.equal(outs[True].data[POS], outs[False].data[POS])
        # quantization moves a centroid by at most 1.5 * leaf / 2**q
        exact_out = voxel_downsample(pb, 2.0, bounds=(T(ZERO3), None),
                                     semantics=semantics, grid_bits=10,
                                     sort_tiles=tiles)
        dev = (outs[True].data[POS] - exact_out.data[POS]).abs().max()
        assert 0 < float(dev) <= 1.5 * 2.0 / (1 << qbits) + 1e-5


@pytest.mark.parametrize("qbits", [10, None])
def test_fast_paths_match_jax_fused_reduce(rng, qbits):
    """One 65 536-row block in 16 tiles through the JAX package's fused
    Pallas reduce (interpret mode), quantized (``qbits`` 10) and exact-f32
    (None), against the port's fast path."""
    n, tiles = jvr.REDUCE_BLOCK, 16
    jb = _jax_batch(_slab_columns(rng, n, tiles), n - 1000, SLAB_NAMES)
    pb = _port_batch(jb, SLAB_NAMES)
    kw = dict(semantics="floor", grid_bits=10, sort_tiles=tiles,
              position_quantization_bits=qbits)
    want = _jax_forced(True, lambda: _jax_voxel(
        jb, 2.0, bounds=(jnp.asarray(ZERO3), None), **kw))
    got = voxel_downsample(pb, 2.0, bounds=(T(ZERO3), None), **kw)
    _assert_batches_agree(
        want, got, dict(rtol=1e-6, atol=1e-4 if qbits is None else 2e-5))


def _quantized_oracle(keys, qword, qbits, window, leaf, bmin):
    """f64 centroid of every voxel from the head's own keys and residual
    words, in Morton order (the oracle of tests/test_pallas_kernels.py)."""
    uniq, inverse, counts = np.unique(keys, return_inverse=True,
                                      return_counts=True)
    from pasture_tpu.math.morton import morton_decode_u32
    cells = np.stack([np.asarray(c) for c in morton_decode_u32(
        jnp.asarray(uniq.astype(np.uint32)))], axis=1).astype(np.float64)
    qm = (1 << qbits) - 1
    qs = np.stack([(qword >> (2 * qbits)) & qm, (qword >> qbits) & qm,
                   qword & qm], axis=1).astype(np.float64)
    mean = np.stack([np.bincount(inverse, weights=qs[:, a])
                     for a in range(3)], axis=1) / counts[:, None]
    return (cells + (mean + 0.5) * (window / (1 << qbits))) * leaf + bmin


@pytest.mark.parametrize("semantics", ["floor", "nearest"])
def test_quantized_precomputed_path_matches_jax(rng, semantics):
    """fused_voxel_head (Pallas, interpret mode) -> voxel_downsample(
    precomputed=(keys, qword)) in the JAX package, against the port fed the
    same words, and the port's own head + downsample as a whole."""
    from test_torch_heads_q import (BMIN, ROT, SCALE, TRANS, _jargs,
                                    _off_faces, _pargs)
    n, leaf, qbits = 32768, 0.5, 10
    local = _off_faces(rng, leaf, semantics, qbits, n=n)
    inten = rng.integers(0, 65536, n).astype(np.uint16)
    cls = rng.integers(0, 32, n).astype(np.uint8)
    keys, qword = jft.fused_voxel_head(*_jargs(local, leaf), qbits=qbits,
                                       semantics=semantics, interpret=True)
    jb = _jax_batch({INT: inten, CLS: cls}, n - 50, SLAB_NAMES)
    pb = _port_batch(jb, SLAB_NAMES)
    kw = dict(semantics=semantics, grid_bits=10,
              position_quantization_bits=qbits)
    want = _jax_forced(False, lambda: _jax_voxel(
        jb, leaf, bounds=(jnp.asarray(BMIN), None),
        precomputed=(keys, qword), **kw))
    # (a) the same words, as carriers, through the port's generic path
    words = tuple(T(np.asarray(w).astype(np.int64)) for w in (keys, qword))
    got = voxel_downsample(pb, leaf, bounds=(T(BMIN), None),
                           precomputed=words, **kw)
    nv = _assert_batches_agree(want, got, dict(rtol=1e-6, atol=2e-5))
    # (b) the port's own head (plain version): the same words on these
    # off-face points; 8 tiles of one capacity keep the fast path eligible
    # (a voxel may then span tiles, so the count is not compared)
    pk, pq = ft.fused_voxel_head(*_pargs(local, leaf), qbits=qbits,
                                 semantics=semantics)
    assert torch.equal(pk, words[0]) and torch.equal(pq, words[1])
    fast = voxel_downsample(pb, leaf, bounds=(T(BMIN), None),
                            precomputed=(pk, pq), sort_tiles=8, **kw)
    slow = voxel_downsample(pb, leaf, bounds=(T(BMIN), None),
                            precomputed=(pk, pq), sort_tiles=8, fused=False,
                            **kw)
    assert int(fast.count) == int(slow.count) >= nv
    for name in SLAB_NAMES:
        assert torch.equal(fast.data[name], slow.data[name]), name
    # (c) the f64 oracle built from the head's own words
    oracle = _quantized_oracle(
        np.asarray(keys)[:n - 50], np.asarray(qword)[:n - 50], qbits,
        1.5 if semantics == "nearest" else 1.0, leaf, BMIN)
    assert oracle.shape[0] == nv
    err = np.linalg.norm(got.data[POS][:nv].numpy() - oracle, axis=1).max()
    assert err < 1e-4


def test_exact_f32_precomputed_path_matches_jax(rng):
    """voxel_downsample(precomputed=(keys, None)): the position column rides
    the sort, keys are taken as given — JAX generic path against the port's
    fast and generic paths."""
    n, tiles = 8192, 4
    jb = _jax_batch(_slab_columns(rng, n, tiles), n - 123, SLAB_NAMES)
    pb = _port_batch(jb, SLAB_NAMES)
    cells = jvoxel.voxel_indices(jb.data[POS], jb.valid_mask(), 2.0,
                                 jnp.asarray(ZERO3), "floor", 10)
    keys = jvoxel._keys(cells, jb.valid_mask(), 10)[0]
    kw = dict(semantics="floor", grid_bits=10, sort_tiles=tiles)
    want = _jax_forced(False, lambda: _jax_voxel(
        jb, 2.0, bounds=(jnp.asarray(ZERO3), None), precomputed=(keys, None),
        **kw))
    pkeys = T(np.asarray(keys).astype(np.int64))
    for fused in (True, False):
        got = voxel_downsample(pb, 2.0, bounds=(T(ZERO3), None),
                               precomputed=(pkeys, None), fused=fused, **kw)
        _assert_batches_agree(want, got, dict(rtol=1e-6, atol=1e-4))
    # the same as computing the keys inside
    inside = voxel_downsample(pb, 2.0, bounds=(T(ZERO3), None), **kw)
    for name in SLAB_NAMES:
        assert torch.equal(inside.data[name], got.data[name]) or \
            name == POS
    # NaN positions in the invalid tail contribute nothing
    pos = pb.data[POS].clone()
    pos[n - 123:] = float("nan")
    nan_tail = voxel_downsample(pb.with_column(POS, pos), 2.0,
                                bounds=(T(ZERO3), None),
                                precomputed=(pkeys, None), **kw)
    assert torch.isfinite(nan_tail.data[POS]).all()
    assert int(nan_tail.count) == int(want.count)


@pytest.mark.parametrize("kw", [
    dict(grid_bits=20, position_quantization_bits=10),
    dict(grid_bits=10, position_quantization_bits=11),      # 3 * q > 32
    dict(grid_bits=10, position_quantization_bits=10,
         policies={POS: "max"}),
], ids=["grid_bits_20", "qbits_11", "position_not_mean"])
def test_quantization_falls_back_silently_to_the_exact_path(rng, kw):
    """Where the quantized path does not apply the call runs the exact
    path (the JAX package is asked once: each case compiles its own
    program there)."""
    n = 2048
    jb = _jax_batch(_slab_columns(rng, n, 1), n - 77, SLAB_NAMES)
    pb = _port_batch(jb, SLAB_NAMES)
    exact_kw = {k: v for k, v in kw.items()
                if k != "position_quantization_bits"}
    got = voxel_downsample(pb, 2.0, bounds=(T(ZERO3), None), **kw)
    exact = voxel_downsample(pb, 2.0, bounds=(T(ZERO3), None), **exact_kw)
    for name in SLAB_NAMES:
        assert torch.equal(got.data[name], exact.data[name]), name
    if kw["position_quantization_bits"] == 11:
        want = _jax_voxel(
            jb, 2.0, bounds=(jnp.asarray(ZERO3), None), **kw)
        _assert_batches_agree(want, got, dict(rtol=1e-6, atol=2e-5))


# ---- the smoke script's further paths, rehearsed on the CPU -------------------

def test_smoke_paths_agree_with_the_generic_path_on_the_cpu(rng):
    """The three further paths of the GPU smoke script at 32 768 points in
    64 tiles, through the same functions, each against the port's generic
    path (on the CPU the wrappers run their plain versions)."""
    n, zt, xt = 32768, 8, 8
    tiles = zt * xt
    local, inten, cls = chip_smoke.make_columns(n, zt, xt)
    batch = chip_smoke.make_batch(local, inten, cls, device="cpu")
    affine = chip_smoke.affine_on("cpu")

    def same(a, b, atol):
        nv = int(a.count)
        assert nv == int(b.count) and 0 < nv < n
        for name in (INT, CLS):
            assert torch.equal(a.data[name], b.data[name]), name
        np.testing.assert_allclose(a.data[POS].numpy(), b.data[POS].numpy(),
                                   rtol=0, atol=atol)
        return nv

    # C: exact-f32, keys from the head and keys made inside
    head = chip_smoke.exact_f32_head(batch, affine)
    for pre in (True, False):
        nv = same(chip_smoke.path_exact_f32(batch, head, tiles,
                                            precomputed=pre),
                  chip_smoke.path_exact_f32(batch, head, tiles, fused=False,
                                            precomputed=pre), 1e-4)
    # the exact-local main path finds the same voxels, the same centroids
    main = chip_smoke.pipeline_batch(batch, affine, tiles)
    exact = chip_smoke.path_exact_f32(batch, head, tiles)
    assert int(main.count) == nv
    np.testing.assert_allclose(main.data[POS].numpy(),
                               exact.data[POS].numpy(), rtol=0, atol=2e-4)
    # B: quantized, words from the head and words made inside
    qhead = chip_smoke.quantized_head(batch, affine)
    quant = chip_smoke.path_quantized(batch, qhead, tiles)
    assert same(quant, chip_smoke.path_quantized(batch, qhead, tiles,
                                                 fused=False), 0.0) == nv
    wbatch = chip_smoke.attribute_batch(batch, head[1])
    same(chip_smoke.path_quantized_internal(wbatch, qhead[0], tiles),
         chip_smoke.path_quantized_internal(wbatch, qhead[0], tiles,
                                            fused=False), 0.0)
    # quantization moves a centroid by at most a residual step and a half
    dev = (quant.data[POS] - exact.data[POS]).abs().max()
    assert 0 < float(dev) <= 1.5 * chip_smoke.LEAF / 1024 + 2e-4
    # A: filter, generic 20-bit grid, bounds and min/max of the result
    kept, voxels, box, (imin, imax) = chip_smoke.path_filter_grid(wbatch)
    assert int(kept.count) == int((cls != 7).sum())
    np.testing.assert_array_equal(kept.data[INT].numpy()[:int(kept.count)],
                                  inten[cls != 7])
    nva = int(voxels.count)
    assert 0 < nva < int(kept.count)
    vpos = voxels.data[POS].numpy()[:nva]
    np.testing.assert_array_equal(box.min, vpos.min(axis=0))
    np.testing.assert_array_equal(box.max, vpos.max(axis=0))
    assert imin == voxels.data[INT].numpy()[:nva].min() <= imax
    assert not (voxels.data[CLS][:nva] == 7).any()
