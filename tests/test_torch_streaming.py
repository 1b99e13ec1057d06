"""Device ingest and the streaming fold of the port against the JAX package
on the same written LAS files (CPU): ``stream_batches`` (with and without
read-ahead), ``streaming_bounds``, ``streaming_voxel_downsample`` in both
mode variants (the top-2 vote and the exact run tables), the one-chunk
file under tiled sorts, ``read_batch`` and ``batch_positions``.  Counts,
keys and integer columns exact; float columns at the reference test's
tolerance (tests/test_streaming.py: centroids atol 1e-5, intensity within
one unit, GPS time rtol 1e-6)."""

import numpy as np
import pytest
import torch

from pasture_tpu.buffers.host import HostPointBuffer as JHostPointBuffer
from pasture_tpu.io import batch_positions as jbatch_positions
from pasture_tpu.io import read_batch as jread_batch
from pasture_tpu.io import stream_batches as jstream_batches
from pasture_tpu.io import streaming_bounds as jstreaming_bounds
from pasture_tpu.io import streaming_voxel_downsample as jstreaming_voxel
from pasture_tpu.io import write_all as jwrite_all
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.layout.schema import PointSchema as JPointSchema

from pasture_tpu_torch import interop
from pasture_tpu_torch.io import (batch_positions, read_batch, stream_batches,
                                  streaming_bounds,
                                  streaming_voxel_downsample)
from pasture_tpu_torch.io import streaming as streaming_mod
from pasture_tpu_torch.ops import voxel_downsample

POS, INT, CLS, GPS = "Position3D", "Intensity", "Classification", "GpsTime"
N = 6000
CHUNK = 2048


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    """A LAS file of N points on 12 m x 12 m x 3 m (1 mm scale) with
    spatially coherent classes, written by the JAX package."""
    rng = np.random.default_rng(5)
    pos = np.round(rng.uniform(0, [12, 12, 3], (N, 3)), 3)
    cols = {POS: pos, INT: rng.integers(0, 1000, N).astype(np.uint16),
            CLS: (np.floor(pos[:, 0]) % 7).astype(np.uint8),
            GPS: rng.uniform(0, 1e5, N)}
    schema = JPointSchema.from_attributes(
        [jatt.POSITION_3D, jatt.INTENSITY, jatt.CLASSIFICATION,
         jatt.GPS_TIME])
    path = tmp_path_factory.mktemp("streaming") / "survey.las"
    jwrite_all(JHostPointBuffer.from_columns(schema, cols), path)
    return path


def _assert_voxels(got, want):
    nv = int(want.count)
    assert int(got.count) == nv > 0
    cols, _, _, _ = interop.batch_to_reference_arrays(got)
    np.testing.assert_allclose(cols[POS][:nv], np.asarray(want.data[POS])[:nv],
                               rtol=0, atol=1e-5)
    di = (cols[INT][:nv].astype(np.int64)
          - np.asarray(want.data[INT])[:nv].astype(np.int64))
    assert np.abs(di).max() <= 1
    np.testing.assert_array_equal(cols[CLS][:nv],
                                  np.asarray(want.data[CLS])[:nv])
    np.testing.assert_allclose(cols[GPS][:nv], np.asarray(want.data[GPS])[:nv],
                               rtol=1e-6)
    return nv


@pytest.mark.parametrize("read_ahead", (True, False))
def test_stream_batches_match_jax(survey, read_ahead):
    """Fixed-capacity chunks, the last one zero-padded, equal to JAX's."""
    got = list(stream_batches(survey, CHUNK, read_ahead=read_ahead,
                              device="cpu"))
    want = list(jstream_batches(survey, CHUNK))
    assert len(got) == len(want) == -(-N // CHUNK)
    for g, w in zip(got, want):
        assert g.capacity == CHUNK and int(g.count) == int(w.count)
        cols, _, _, _ = interop.batch_to_reference_arrays(g)
        for name, col in w.data.items():
            np.testing.assert_array_equal(cols[name], np.asarray(col),
                                          err_msg=name)
    assert not got[-1].data[POS][int(got[-1].count):].any()


def test_streaming_bounds_match_jax(survey):
    got = streaming_bounds(survey, CHUNK, device="cpu")
    want = jstreaming_bounds(survey, CHUNK)
    np.testing.assert_array_equal(got.min, want.min)
    np.testing.assert_array_equal(got.max, want.max)


@pytest.mark.parametrize("mode_runs", (False, True))
def test_streaming_voxel_downsample_matches_jax(survey, mode_runs):
    """Both mode variants, tiled per-chunk sorts on a 10-bit grid, header
    bounds: equal to JAX's fold, aux included; with run tables also equal
    to the port's one-shot voxelization of the whole file."""
    kw = dict(chunk_points=CHUNK, grid_bits=10, use_metadata_bounds=True,
              sort_tiles=CHUNK // 256, with_aux=True)
    if mode_runs:
        kw["mode_runs"] = True
    before = dict(streaming_mod.HOST_SYNCS)
    got, gaux = streaming_voxel_downsample(survey, 0.5, device="cpu", **kw)
    syncs = (streaming_mod.HOST_SYNCS["streaming_voxel_downsample"]
             - before["streaming_voxel_downsample"])
    # growth at the second and third chunk, and the run tables' backstop
    assert syncs == 2 + int(mode_runs)
    want, waux = jstreaming_voxel(survey, 0.5, **kw)
    nv = _assert_voxels(got, want)
    ref = interop.aux_to_reference(gaux)
    np.testing.assert_array_equal(ref["keys"][0], np.asarray(waux["keys"][0]))
    np.testing.assert_array_equal(ref["counts"], np.asarray(waux["counts"]))
    assert int(gaux["counts"].sum()) == N
    if mode_runs:
        rt, wrt = ref["mode_runs"][CLS], waux["mode_runs"][CLS]
        for k in ("values", "counts", "num_runs"):
            np.testing.assert_array_equal(rt[k], np.asarray(wrt[k]))
        assert not bool(gaux["mode_runs"][CLS]["input_truncated"])
        whole = read_batch(survey, device="cpu", exact_positions=False)
        one = voxel_downsample(
            whole, 0.5, bounds=(gmin(survey), None), semantics="floor",
            grid_bits=10, fused=False)
        assert int(one.count) == nv
        assert torch.equal(got.data[CLS][:nv], one.data[CLS][:nv])
        np.testing.assert_allclose(got.data[POS][:nv].numpy(),
                                   one.data[POS][:nv].numpy(), atol=1e-5)


def gmin(path):
    from pasture_tpu_torch.io import open_reader

    with open_reader(path) as r:
        return torch.tensor(np.asarray(r.get_metadata().bounds().min,
                                       np.float32))


def test_one_chunk_file_keeps_rows_per_tile(survey):
    """A file of one chunk under tiled sorts is not merged: the result keeps
    one row per (tile, voxel), more than the one-shot's voxels — as in
    the JAX package."""
    kw = dict(chunk_points=8192, grid_bits=10, use_metadata_bounds=True,
              sort_tiles=16)
    got = streaming_voxel_downsample(survey, 0.5, device="cpu", **kw)
    want = jstreaming_voxel(survey, 0.5, **kw)
    _assert_voxels(got, want)
    one = streaming_voxel_downsample(survey, 0.5, device="cpu",
                                     **dict(kw, sort_tiles=1))
    assert int(got.count) > int(one.count)


def test_read_batch_and_batch_positions_match_jax(survey):
    """Exact ingest: i32 locals and the f64 scale / offset / i32 anchor
    meta equal; positions decoded on the device equal, anchored and not."""
    got = read_batch(survey, device="cpu")
    want = jread_batch(survey)
    assert int(got.count) == int(want.count) == N
    cols, _, _, meta = interop.batch_to_reference_arrays(got)
    for name, col in want.data.items():
        np.testing.assert_array_equal(cols[name], np.asarray(col),
                                      err_msg=name)
    for k, v in want.meta.items():
        assert meta[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(meta[k], np.asarray(v), err_msg=k)
    for anchored in (True, False):
        np.testing.assert_array_equal(
            batch_positions(got, anchored=anchored).numpy(),
            np.asarray(jbatch_positions(want, anchored=anchored)))
    plain = read_batch(survey, exact_positions=False, device="cpu")
    np.testing.assert_array_equal(
        batch_positions(plain).numpy(),
        np.asarray(jbatch_positions(jread_batch(survey,
                                                exact_positions=False))))


def test_chip_smoke_file_to_map_rehearsal(tmp_path, monkeypatch):
    """``chip_smoke.py``'s path_file_to_map at a small size on the CPU: the
    bench's survey written by the port as LAS and LAZ, the gate (the fold
    with run tables against the one-shot voxelization and the f64 oracle),
    and the LAZ fold equal to the LAS fold bit for bit."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "FILE_CHUNK", 4096)
    monkeypatch.setattr(chip_smoke, "FILE_TILE", 256)
    buf = chip_smoke.make_survey(12_000)
    las, laz = tmp_path / "survey.las", tmp_path / "survey.laz"
    chip_smoke.write_all(buf, las)
    chip_smoke.write_all(buf, laz)
    gate = chip_smoke.gate_file_to_map(las, "cpu")
    assert gate["gate_passed"] and gate["voxels"] > 0
    assert gate["max_err_vs_f64_oracle"] < 5e-4
    # reported, not gated: at this size the classes vary within a voxel
    assert 0 <= gate["top2_vote_classification_mismatch_share"] < 1
    chip_smoke.compare_folds(
        "laz", chip_smoke.file_fold(laz, "cpu", with_aux=True),
        chip_smoke.file_fold(las, "cpu", with_aux=True))


@pytest.mark.parametrize("module", ("pasture_tpu_torch.io.base",
                                    "pasture_tpu_torch.io.streaming",
                                    "pasture_tpu_torch.ops.voxel_merge"))
def test_docstring_examples(module):
    """The examples in the docstrings of the new modules run as written."""
    import doctest
    import importlib

    failures, attempted = doctest.testmod(importlib.import_module(module))
    assert attempted > 0 and failures == 0
