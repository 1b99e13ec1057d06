"""Stream compaction and predicate filtering of pasture_tpu_torch against
the JAX package on the same numpy inputs (CPU): the compaction kernel's
plain version against ``compact_columns`` and against the Pallas kernel in
interpret mode, ``compact_batch`` / ``filter_batch`` against theirs.

The two packages differ past the kept count by contract (the port compacts
globally and zeroes the tail, the JAX package leaves it unspecified), so
rows ``[:count]`` are compared, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pasture_tpu.buffers.device as jdev
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.layout.schema import PointSchema as JPointSchema
from pasture_tpu.ops.compact import compact_columns as j_compact_columns
from pasture_tpu.ops import filter_batch as j_filter_batch
from pasture_tpu.ops.kernels.compact_kernel import (PALLAS_COMPACT_BLOCK,
                                                    blockwise_compact_pallas)

from pasture_tpu_torch import interop
from pasture_tpu_torch.ops import (compact_batch, compact_columns,
                                   filter_batch)
from pasture_tpu_torch.ops.kernels import compact_kernel as ck

T = torch.from_numpy


def _column(rng, n, dtype, width):
    shape = (n,) if width == 1 else (n, width)
    if np.dtype(dtype).kind == "f":
        return rng.uniform(-100, 100, shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype,
                        endpoint=True)


@pytest.mark.parametrize("dtype,width", [
    (np.uint8, 1), (np.int16, 1), (np.int32, 1), (np.float32, 1),
    (np.int64, 1), (np.float64, 1), (np.int32, 3), (np.uint8, 3),
    (np.float64, 3), (np.int16, 5)])
def test_compact_columns_every_carrier_width(rng, dtype, width):
    """1-, 2-, 4- and 8-byte carriers, scalar and (N, C) columns, ragged
    N: kept rows in order, the count, a zero tail."""
    n = 2500                                   # no multiple of any block
    keep = rng.random(n) < 0.7
    col = _column(rng, n, dtype, width)
    before = dict(ck.LAUNCHES)
    (got,), count = compact_columns([T(col)], T(keep))
    assert ck.LAUNCHES == before               # CPU tensors launch nothing
    k = int(keep.sum())
    assert count.dtype == torch.int32 and count.ndim == 0
    assert int(count) == k
    assert got.dtype == T(col).dtype and got.shape == col.shape
    np.testing.assert_array_equal(got.numpy()[:k], col[keep])
    assert not got.numpy()[k:].any()
    if width == 1 and np.dtype(dtype).itemsize == 4:
        # what the JAX package's kernel path takes: 1-D 4-byte columns
        (want,), wc = j_compact_columns([jnp.asarray(col)],
                                        jnp.asarray(keep))
        assert int(wc) == k
        np.testing.assert_array_equal(got.numpy()[:k], np.asarray(want)[:k])


@pytest.mark.parametrize("case", ["empty", "all", "none", "one_row",
                                  "block_edge"])
def test_compact_columns_edge_cases(rng, case):
    n = {"empty": 0, "one_row": 1,
         "block_edge": 2 * ck.ROWS_PER_BLOCK + 1}.get(case, 777)
    keep = {"all": np.ones(n, bool), "none": np.zeros(n, bool)}.get(
        case, rng.random(n) < 0.5)
    a = rng.integers(0, 1000, n).astype(np.int32)
    f = rng.random((n, 3)).astype(np.float32)
    (ga, gf), count = compact_columns([T(a), T(f)], T(keep))
    k = int(keep.sum())
    assert int(count) == k
    np.testing.assert_array_equal(ga.numpy()[:k], a[keep])
    np.testing.assert_array_equal(gf.numpy()[:k], f[keep])
    assert not ga.numpy()[k:].any() and not gf.numpy()[k:].any()
    if n == 777:
        (wa,), wc = j_compact_columns([jnp.asarray(a)], jnp.asarray(keep))
        assert int(wc) == k
        np.testing.assert_array_equal(ga.numpy()[:k], np.asarray(wa)[:k])


def test_compact_argument_errors(rng):
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="bool"):
        compact_columns([a], torch.ones(8, dtype=torch.uint8))
    with pytest.raises(ValueError, match="length"):
        compact_columns([a], torch.ones(9, dtype=torch.bool))
    with pytest.raises(TypeError, match="bool"):
        ck.blockwise_compact_plain([a], torch.ones((8, 1), dtype=torch.bool))


def test_compact_plain_matches_pallas_interpret(rng):
    """Two 65 536-row blocks through the Pallas kernel (interpret mode),
    which compacts each block on its own: its blocks' kept prefixes,
    concatenated, are the port's global prefix."""
    n = 2 * PALLAS_COMPACT_BLOCK
    keep = rng.random(n) < 0.9
    vals = np.arange(n, dtype=np.int32)
    f = rng.random(n).astype(np.float32)
    (c1, c2), cnts = blockwise_compact_pallas(
        [jnp.asarray(vals), jnp.asarray(f)], jnp.asarray(keep),
        interpret=True)
    c1, c2, cnts = np.asarray(c1), np.asarray(c2), np.asarray(cnts)
    B = PALLAS_COMPACT_BLOCK
    want1 = np.concatenate([c1[b * B:b * B + cnts[b]] for b in range(2)])
    want2 = np.concatenate([c2[b * B:b * B + cnts[b]] for b in range(2)])
    (g1, g2), count = ck.blockwise_compact([T(vals), T(f)], T(keep))
    k = int(count)
    assert k == int(cnts.sum()) == int(keep.sum())
    np.testing.assert_array_equal(g1.numpy()[:k], want1)
    np.testing.assert_array_equal(g2.numpy()[:k], want2)
    assert not g1.numpy()[k:].any() and not g2.numpy()[k:].any()


NAMES = ("Position3D", "Intensity", "Classification", "GpsTime")


def _batches(rng, n, count):
    cols = {
        "Position3D": rng.uniform(-50, 50, (n, 3)).astype(np.float32),
        "Intensity": rng.integers(0, 65536, n).astype(np.uint16),
        "Classification": rng.integers(0, 32, n).astype(np.uint8),
        "GpsTime": rng.uniform(0, 1e5, n),                       # f64
    }
    schema = JPointSchema.from_attributes(
        [a for name in NAMES for a in jatt.BUILTIN_ATTRIBUTES
         if a.name == name])
    jb = jdev.PointBatch({k: jnp.asarray(v) for k, v in cols.items()},
                         jnp.asarray(count, jnp.int32), schema, {})
    pb = interop.batch_from_reference_arrays(cols, count, NAMES,
                                             device="cpu")
    return cols, jb, pb


@pytest.mark.parametrize("n,count", [(1000, 1000), (1000, 613), (64, 0)])
def test_filter_batch_matches_jax(rng, n, count):
    cols, jb, pb = _batches(rng, n, count)
    want = j_filter_batch(jb, lambda d: d["Classification"] != 7)
    got = filter_batch(pb, lambda d: d["Classification"] != 7)
    k = int(want.count)
    assert got.count.dtype == torch.int32 and got.count.ndim == 0
    assert int(got.count) == k == int(
        (cols["Classification"][:count] != 7).sum())
    assert got.schema is pb.schema and got.capacity == n
    gcols, gcount, names, _ = interop.batch_to_reference_arrays(got)
    assert gcount == k and names == NAMES
    for name in NAMES:
        w = np.asarray(want.data[name])
        assert gcols[name].dtype == w.dtype, name
        np.testing.assert_array_equal(gcols[name][:k], w[:k], err_msg=name)
        assert not gcols[name][k:].any(), name       # the port zeroes the tail


def test_compact_batch_drops_padding_whatever_the_mask_says(rng):
    cols, jb, pb = _batches(rng, 128, 100)
    out = compact_batch(pb, torch.ones(128, dtype=torch.bool))
    assert int(out.count) == 100
    np.testing.assert_array_equal(out.data["Position3D"].numpy()[:100],
                                  cols["Position3D"][:100])
    assert not out.data["Position3D"].numpy()[100:].any()
    keep = rng.random(128) < 0.5
    want = np.flatnonzero(keep[:100])
    out = compact_batch(pb, T(keep))
    assert int(out.count) == len(want)
    np.testing.assert_array_equal(out.data["Intensity"].numpy()[:len(want)],
                                  cols["Intensity"][:100][want])


def test_compact_wide_rows_match_jax(rng):
    """A 40 000-byte row (wider than one launch of the kernel takes) and a
    10 001-byte row at an odd byte offset: the CPU compaction equals the
    JAX package's, which compacts 1-D columns — so it compacts the row
    ids, and the wide rows are taken by those ids."""
    n = 300
    keep = rng.random(n) < 0.6
    wide = rng.integers(0, 256, (n, 40_000), dtype=np.uint8)
    raw = rng.integers(0, 256, n * 10_001 + 1, dtype=np.uint8)
    odd = raw[1:].reshape(n, 10_001)
    got, count = compact_columns([T(wide), T(odd)], T(keep))
    (ids,), wc = j_compact_columns([jnp.arange(n, dtype=jnp.int32)],
                                   jnp.asarray(keep))
    k = int(keep.sum())
    assert int(count) == int(wc) == k
    ids = np.asarray(ids)[:k]
    for g, col in zip(got, (wide, odd)):
        np.testing.assert_array_equal(g.numpy()[:k], col[ids])
        assert not g.numpy()[k:].any()


@pytest.mark.parametrize("row_bytes", [1, 36_592, ck.LAUNCH_ROW_BYTES,
                                       ck.LAUNCH_ROW_BYTES + 1, 40_000,
                                       73_185, 73_217, 1 << 20])
def test_compact_column_slices_cover_the_row(row_bytes):
    """A row fits one launch whole, or goes through byte slices that cover
    it once, in order, each at most ``SLICE_BYTES`` wide and within 16
    bytes a slice of an even share, starting on a multiple of 16 bytes, and
    whose staged bytes
    (a slot a row, the full row its pitch) fit a launch."""
    slices = ck.column_slices(row_bytes)
    if row_bytes <= ck.LAUNCH_ROW_BYTES:
        assert slices == [(0, row_bytes)]
        assert ck.staged_bytes(row_bytes, row_bytes) == row_bytes
        return
    at = 0
    for off, nb in slices:
        assert off == at and off % 16 == 0
        assert nb <= ck.SLICE_BYTES
        assert abs(nb - row_bytes / len(slices)) <= 16 * len(slices)
        assert nb < ck.staged_bytes(nb, row_bytes) <= ck.LAUNCH_ROW_BYTES
        assert ck.staged_bytes(nb, row_bytes) % 16 == 0
        at += nb
    assert at == row_bytes
    groups = ck.launch_groups([ck.staged_bytes(nb, row_bytes)
                               for _, nb in slices])
    assert groups == [[i] for i in range(len(slices))]


def test_compact_slices_compose_to_the_whole_row(rng):
    """The byte slices of a wide row, each compacted as a column of its own
    (what each further launch does on the card), put together equal the
    whole row compacted."""
    n = 500
    keep = rng.random(n) < 0.3
    col = rng.integers(0, 256, (n, 40_000), dtype=np.uint8)
    (whole,), count = ck.blockwise_compact_plain([T(col)], T(keep))
    parts = [ck.blockwise_compact_plain(
        [T(np.ascontiguousarray(col[:, off:off + nb]))], T(keep))
        for off, nb in ck.column_slices(col.shape[1])]
    assert all(int(c) == int(count) for _, c in parts)
    np.testing.assert_array_equal(
        np.concatenate([p[0].numpy() for p, _ in parts], axis=1),
        whole.numpy())
