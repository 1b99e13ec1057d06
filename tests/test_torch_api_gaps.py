"""The public functions of the port's modules that mirror the JAX package's
one for one — segment reductions, LAS position encoding, batch schema
conversion, the f64 Morton key and ``PointBatch.concatenate`` — against
the JAX package on the same seeded numpy inputs (CPU; the reference under
one ``jax.jit`` per call).  Integers and counts exact, floats to
``assert_allclose``'s defaults, as the reference's own tests hold them
(tests/test_ops.py, test_buffers.py, test_parity_extras.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu.buffers.device import PointBatch as JPointBatch
from pasture_tpu.buffers.host import HostPointBuffer as JHostPointBuffer
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.layout import dtypes as jdt
from pasture_tpu.layout.schema import PointSchema as JPointSchema
from pasture_tpu.math import morton as jmorton
from pasture_tpu.ops import convert as jconvert
from pasture_tpu.ops import reductions as jred
from pasture_tpu.ops import transform as jtransform

from pasture_tpu_torch.buffers import HostPointBuffer, PointBatch
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout import dtypes as dt
from pasture_tpu_torch.layout.dtypes import DevicePolicy
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.math import morton_key_f32
from pasture_tpu_torch.ops import (convert_batch_schema, decode_las_positions,
                                   encode_las_positions, segment_max,
                                   segment_mean, segment_min, segment_mode,
                                   segment_sum)
from pasture_tpu_torch.ops.kernels import compact_kernel as ck

T = torch.from_numpy


def _sorted_ids(rng, n, num_segments, out_of_range=True):
    """Ascending segment ids over ``[0, num_segments)`` that leave some
    segments empty; with ``out_of_range``, a few negative ids first and a
    few at or past ``num_segments`` last (the reference drops them)."""
    ids = np.sort(rng.choice(np.arange(0, num_segments, 2), n))
    if out_of_range:
        ids[:3] = [-5, -1, -1]
        ids[-4:] = [num_segments, num_segments, num_segments + 3, 1 << 20]
    return ids.astype(np.int32)


_SEGMENT_OPS = {"sum": (segment_sum, jred.segment_sum),
                "min": (segment_min, jred.segment_min),
                "max": (segment_max, jred.segment_max)}


@pytest.mark.parametrize("op", sorted(_SEGMENT_OPS))
@pytest.mark.parametrize("dtype,shape", [
    (np.float32, ()), (np.float64, (3,)), (np.int32, ()), (np.uint8, (2,)),
    (np.int16, ())])
def test_segment_reductions_match_jax(rng, op, dtype, shape):
    """Empty segments (the identity), dropped out-of-range ids, ``(N, C)``
    inputs along axis 0, wrapping integer sums."""
    n, ns = 500, 40
    ids = _sorted_ids(rng, n, ns)
    if np.dtype(dtype).kind == "f":
        x = rng.normal(0, 100, (n,) + shape).astype(dtype)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, (n,) + shape, dtype=dtype,
                         endpoint=True)
    ours, ref = _SEGMENT_OPS[op]
    want = np.asarray(jax.jit(ref, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(ids), ns))
    got = ours(T(x), T(ids), ns).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (ns,) + shape
    if np.dtype(dtype).kind == "f":
        np.testing.assert_allclose(got, want)
    else:
        np.testing.assert_array_equal(got, want)
    assert np.unique(ids[(ids >= 0) & (ids < ns)]).size < ns   # some empty


def test_segment_mean_matches_jax(rng):
    """tests/test_ops.py:45's case, then ``(N, C)`` f64 values with given
    counts and an f64 accumulator."""
    x = np.asarray([1.0, 2.0, 3.0, 10.0, 20.0, 0.0])
    seg = np.asarray([0, 0, 0, 1, 1, 2], np.int32)
    out = segment_mean(T(x), T(seg), 4).numpy()
    want = np.asarray(jax.jit(jred.segment_mean, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(seg), 4))
    np.testing.assert_allclose(out[:3], [2.0, 15.0, 0.0])
    np.testing.assert_allclose(out, want)

    n, ns = 300, 25
    ids = _sorted_ids(rng, n, ns)
    v = rng.normal(5, 3, (n, 3))
    counts = rng.integers(1, 9, ns).astype(np.int32)
    mean = jax.jit(jred.segment_mean, static_argnums=(2, 4))
    for c in (None, counts):
        want = np.asarray(mean(jnp.asarray(v), jnp.asarray(ids), ns,
                               None if c is None else jnp.asarray(c),
                               jnp.float64))
        got = segment_mean(T(v), T(ids), ns,
                           None if c is None else T(c), torch.float64)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want)


def test_segment_mode_matches_jax(rng):
    """tests/test_ops.py:38's majority and tie cases (a tie goes to the
    smallest value), then random values with empty segments (int32 max)
    and out-of-range ids."""
    vals = np.asarray([5, 5, 7, 7, 7, 2, 9, 9, 3, 3], np.int32)
    seg = np.asarray([0, 0, 0, 0, 0, 1, 1, 1, 1, 1], np.int32)
    out = segment_mode(T(vals), T(seg), 3).numpy()
    assert out.dtype == np.int32
    assert out[0] == 7 and out[1] == 3
    assert out[2] == np.iinfo(np.int32).max             # empty segment
    mode = jax.jit(jred.segment_mode, static_argnums=2)
    np.testing.assert_array_equal(
        out, np.asarray(mode(jnp.asarray(vals), jnp.asarray(seg), 3)))

    n, ns = 2000, 60
    ids = _sorted_ids(rng, n, ns)
    v = rng.integers(-4, 4, n).astype(np.int16)
    got = segment_mode(T(v), T(ids), ns).numpy()
    want = np.asarray(mode(jnp.asarray(v), jnp.asarray(ids), ns))
    np.testing.assert_array_equal(got, want)


def test_encode_las_positions_round_trip_matches_jax():
    """tests/test_ops.py:60: ``round`` gives the locals back bit for bit,
    ``trunc`` within one unit; both equal to the JAX package's."""
    scale = np.asarray([0.001, 0.001, 0.001])
    offset = np.asarray([100.0, 200.0, -50.0])
    local = np.random.default_rng(0).integers(
        -10**6, 10**6, (100, 3)).astype(np.int32)
    world = decode_las_positions(T(local), T(scale), T(offset),
                                 dtype=torch.float64)
    enc = jax.jit(jtransform.encode_las_positions, static_argnums=4)
    for rounding in ("round", "trunc"):
        got = encode_las_positions(world, T(scale), T(offset),
                                   rounding=rounding).numpy()
        want = np.asarray(enc(jnp.asarray(world.numpy()), jnp.asarray(scale),
                              jnp.asarray(offset), None, rounding))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        encode_las_positions(world, T(scale), T(offset),
                             rounding="round").numpy(), local)
    with pytest.raises(ValueError, match="rounding"):
        encode_las_positions(world, T(scale), rounding="nearest")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_encode_las_positions_saturates_like_jax(dtype):
    """Out of the int32 range the reference's clip runs in the float dtype
    (``2147483647.0`` is ``2**31`` in f32) and XLA's cast saturates; the
    port saturates explicitly.  Halfway values round to even.  With an
    anchor the result is relative to it."""
    world = np.asarray([[1e12, -1e12, 2147483647.0],
                        [2147483648.0, -2147483648.0, -2147483649.0],
                        [2.5, -2.5, 3.5],
                        [-0.5, 0.5, 1.5]], dtype)
    scale = np.ones(3)
    anchor = np.asarray([7, -7, 0], np.int32)
    enc = jax.jit(jtransform.encode_las_positions, static_argnums=4)
    for rounding in ("trunc", "round"):
        for a in (None, anchor):
            got = encode_las_positions(
                T(world), T(scale), None, None if a is None else T(a),
                rounding).numpy()
            want = np.asarray(enc(jnp.asarray(world), jnp.asarray(scale),
                                  None, None if a is None else jnp.asarray(a),
                                  rounding))
            np.testing.assert_array_equal(got, want, err_msg=rounding)
    got = encode_las_positions(T(world), T(scale), rounding="round").numpy()
    assert got[0, 0] == np.iinfo(np.int32).max
    assert got[0, 1] == np.iinfo(np.int32).min
    np.testing.assert_array_equal(got[2:], [[2, -2, 4], [0, 0, 2]])


def _host_buffers(rng, n=10):
    """tests/test_parity_extras.py's buffer, in both packages."""
    cols = {att.POSITION_3D.name: rng.uniform(-1, 1, (n, 3)),
            att.INTENSITY.name: rng.integers(0, 1000, n).astype(np.uint16)}
    ours = HostPointBuffer.from_columns(
        PointSchema.from_attributes([att.POSITION_3D, att.INTENSITY]), cols)
    ref = JHostPointBuffer.from_columns(
        JPointSchema.from_attributes([jatt.POSITION_3D, jatt.INTENSITY]),
        cols)
    return ours, ref


def test_convert_batch_schema_matches_jax(rng):
    """tests/test_parity_extras.py:45 (f32 positions and intensity, a
    zero-filled classification under the exact policy), then ``rename``
    and a missing target without ``fill_missing_with_default``."""
    ours, ref = _host_buffers(rng)
    batch = PointBatch.from_host(ours, policy=DevicePolicy.EXACT,
                                 device="cpu")
    jbatch = JPointBatch.from_host(ref, policy=jdt.DevicePolicy.EXACT)
    target = PointSchema.from_attributes([
        att.POSITION_3D.with_dtype(dt.VEC3F32),
        att.INTENSITY.with_dtype(dt.F32), att.CLASSIFICATION])
    jtarget = JPointSchema.from_attributes([
        jatt.POSITION_3D.with_dtype(jdt.VEC3F32),
        jatt.INTENSITY.with_dtype(jdt.F32), jatt.CLASSIFICATION])
    got = convert_batch_schema(batch, target, policy=DevicePolicy.EXACT,
                               fill_missing_with_default=True)
    want = jax.jit(lambda b: jconvert.convert_batch_schema(
        b, jtarget, policy=jdt.DevicePolicy.EXACT,
        fill_missing_with_default=True))(jbatch)
    assert got.schema is target and got.count is batch.count
    assert got.policy == DevicePolicy.EXACT
    for name in target.names:
        w = np.asarray(want.data[name])
        g = got.data[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name)
    np.testing.assert_allclose(
        got.data[att.INTENSITY.name].numpy()[:10],
        ours.get(att.INTENSITY.name).astype(np.float32))
    assert not got.data[att.CLASSIFICATION.name].numpy().any()

    # rename: the target's i16 "Loudness" from the source's Intensity
    loud = att.PointAttribute("Loudness", dt.I16)
    jloud = jatt.PointAttribute("Loudness", jdt.I16)
    got = convert_batch_schema(batch, PointSchema.from_attributes([loud]),
                               rename={"Loudness": att.INTENSITY.name})
    want = jax.jit(lambda b: jconvert.convert_batch_schema(
        b, JPointSchema.from_attributes([jloud]),
        rename={"Loudness": jatt.INTENSITY.name}))(jbatch)
    np.testing.assert_array_equal(got.data["Loudness"].numpy(),
                                  np.asarray(want.data["Loudness"]))
    with pytest.raises(ValueError, match="no source column"):
        convert_batch_schema(batch, target)


def test_morton_key_f32_matches_jax(rng):
    """The f64 ``hi * 2**30 + lo`` of 30-bit words, from either u32 form."""
    hi = rng.integers(0, 1 << 23, 1000).astype(np.uint32)
    lo = rng.integers(0, 1 << 30, 1000).astype(np.uint32)
    want = np.asarray(jax.jit(jmorton.morton_key_f32)(jnp.asarray(hi),
                                                      jnp.asarray(lo)))
    for form in (np.int64, np.int32):
        got = morton_key_f32(T(hi.astype(form)), T(lo.astype(form)))
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)


SCHEMA = ([att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION],
          [jatt.POSITION_3D, jatt.INTENSITY, jatt.CLASSIFICATION])


def _random_columns(rng, n):
    """tests/test_buffers.py's random buffer."""
    return {"Position3D": rng.uniform(-100, 100, (n, 3)),
            "Intensity": rng.integers(0, 2**16, n, dtype=np.uint16),
            "Classification": rng.integers(0, 255, n, dtype=np.uint8)}


def test_concatenate_matches_jax(rng):
    """tests/test_buffers.py:143: padded inputs compacted, valid rows
    first, in order (rows past the count are zero in the port, so
    ``[:count]`` is compared); ``compact=False`` keeps the raw layout.
    The count is a 0-d int32 tensor; CPU batches launch no kernel."""
    ours, refs = [], []
    for n in (3, 5, 8, 0):
        cols = _random_columns(rng, n)
        ours.append(PointBatch.from_host(
            HostPointBuffer.from_columns(
                PointSchema.from_attributes(SCHEMA[0]), cols),
            capacity=8, device="cpu"))
        refs.append(JPointBatch.from_host(
            JHostPointBuffer.from_columns(
                JPointSchema.from_attributes(SCHEMA[1]), cols), capacity=8))
    # padding rows hold data that must not leak into the result
    for b in ours:
        b.data["Intensity"][int(b.count):] = 4242
    for compact in (True, False):
        before = dict(ck.LAUNCHES)
        got = PointBatch.concatenate(ours, compact=compact)
        assert ck.LAUNCHES == before
        want = jax.jit(lambda *bs: JPointBatch.concatenate(
            bs, compact=compact))(*refs)
        assert got.count.dtype == torch.int32 and got.count.ndim == 0
        assert int(got.count) == int(want.count) == 16
        assert got.capacity == want.capacity == 32
        rows = slice(0, 16) if compact else slice(None)
        for name in ("Position3D", "Intensity", "Classification"):
            g = got.to_host(trim=False).get(name)
            w = want.to_host(trim=False).get(name)
            if not compact and name == "Intensity":
                w = np.where(np.arange(32) % 8 < np.repeat(
                    [3, 5, 8, 0], 8), w, 4242).astype(w.dtype)
            np.testing.assert_array_equal(g[rows], w[rows], err_msg=name)
        if compact:
            assert not got.data["Intensity"][16:].any()


def test_concatenate_compacts_every_column_in_one_call(rng, monkeypatch):
    """``compact=True`` hands every column and one mask over the summed
    capacity to a single ``compact_columns`` call — the compaction kernel
    once on a CUDA batch."""
    import pasture_tpu_torch.ops.compact as compact_mod
    calls = []
    real = compact_mod.compact_columns

    def spy(cols, keep):
        calls.append((len(cols), keep.shape[0]))
        return real(cols, keep)
    monkeypatch.setattr(compact_mod, "compact_columns", spy)
    cols = _random_columns(rng, 5)
    b = PointBatch.from_host(HostPointBuffer.from_columns(
        PointSchema.from_attributes(SCHEMA[0]), cols), capacity=8,
        device="cpu")
    out = PointBatch.concatenate([b, b, b])
    assert calls == [(3, 24)]
    np.testing.assert_array_equal(out.to_host().get("Intensity"),
                                  np.tile(cols["Intensity"], 3))


def test_top_level_aabb_as_the_reference_calls_it(rng):
    """``pasture_tpu_torch.AABB`` is the math module's, and the reference's
    top-level calls give the same boxes."""
    import pasture_tpu
    import pasture_tpu_torch
    from pasture_tpu_torch.math import aabb

    assert pasture_tpu_torch.AABB is aabb.AABB
    pts = rng.uniform(-5, 5, (64, 3))
    mine = pasture_tpu_torch.AABB.from_points(pts)
    ref = pasture_tpu.AABB.from_points(pts)
    for got, want in ((mine, ref),
                      (mine.as_cubic(), ref.as_cubic()),
                      (mine.extend_with_point([9.0, 0.0, 0.0]),
                       ref.extend_with_point([9.0, 0.0, 0.0]))):
        np.testing.assert_array_equal(got.min, want.min)
        np.testing.assert_array_equal(got.max, want.max)
    assert mine.contains(pts[0]) == ref.contains(pts[0])


def test_math_align_to_as_the_reference_calls_it():
    from pasture_tpu import math as jmath
    from pasture_tpu_torch import math as tmath

    assert "align_to" in tmath.__all__
    for value, alignment in ((0, 8), (1, 8), (8, 8), (13, 4), (7, 1),
                             (5, 0), (100, 64)):
        assert tmath.align_to(value, alignment) == \
            jmath.align_to(value, alignment)


@pytest.mark.parametrize("tiles", (0, 1, 4))
def test_compact_columns_takes_tiles_and_ignores_it(rng, tiles):
    """``compact_columns(cols, keep, tiles=)`` as the reference's callers
    write it: the kept prefix and count equal the JAX package's and the
    port's own call without ``tiles``."""
    from pasture_tpu.ops.compact import compact_columns as j_compact
    from pasture_tpu_torch.ops import compact_columns

    n = 1000
    cols = [rng.integers(0, 1 << 30, n).astype(np.int32),
            rng.uniform(0, 1, n).astype(np.float32)]
    keep = rng.uniform(0, 1, n) < 0.4
    got, count = compact_columns([T(c) for c in cols], T(keep), tiles=tiles)
    plain, plain_count = compact_columns([T(c) for c in cols], T(keep))
    want, want_count = j_compact([jnp.asarray(c) for c in cols],
                                 jnp.asarray(keep), tiles=tiles)
    k = int(want_count)
    assert int(count) == int(plain_count) == k == int(keep.sum())
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g[:k].numpy(), np.asarray(w)[:k])


def test_profiling_trace_takes_create_perfetto_link(tmp_path):
    """``trace(log_dir, create_perfetto_link=...)`` as the reference's
    callers write it: the Chrome trace is written; the flag sits where the
    reference's does, second, defaulting to False."""
    import inspect

    from pasture_tpu.utils import profiling as jprofiling
    from pasture_tpu_torch.utils.profiling import trace

    params = list(inspect.signature(trace).parameters.values())
    want = list(inspect.signature(
        inspect.unwrap(jprofiling.trace)).parameters.values())
    assert [(p.name, p.default) for p in params] == \
        [(p.name, p.default) for p in want]
    with trace(str(tmp_path), create_perfetto_link=True):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
