"""Merge statistics and the two-stage merge of the port against the JAX
package on the CPU: ``voxel_downsample(with_aux=True[, mode_runs=True])``
column by column, then ``merge_voxel_batches`` of 2 and 3 partials (fold
equal to flat merge), the run-table cap and ``input_truncated`` across a
fold.  Mirrors tests/test_voxel_merge.py.  Integer statistics, keys and
run tables must be equal; float means meet the reference test's tolerance
(centroids atol 2e-5, integer means within one unit of the cast, GPS time
rtol 1e-6).  The reference runs under one ``jax.jit`` per call shape."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pasture_tpu.buffers.device as jdev
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.layout.schema import PointSchema as JPointSchema
from pasture_tpu.ops import merge_voxel_batches as jmerge
from pasture_tpu.ops import voxel_downsample as jvoxel

from pasture_tpu_torch import interop
from pasture_tpu_torch.ops import merge_voxel_batches, voxel_downsample

POS, INT, CLS, GPS = "Position3D", "Intensity", "Classification", "GpsTime"
NAMES = (POS, INT, CLS, GPS)
CAP = 1024      # every partial's capacity (one JAX compile per config)
LEAF = 0.5


@functools.lru_cache(maxsize=None)
def _jvox(static, leaf=LEAF):
    kw = dict(static)
    return jax.jit(lambda b: jvoxel(b, leaf, bounds=(jnp.zeros(3, jnp.float32),
                                                     None),
                                    semantics="floor", with_aux=True, **kw))


@functools.lru_cache(maxsize=None)
def _jmerge(static):
    return jax.jit(lambda parts: jmerge(parts, **dict(static)))


def _cloud(rng, n, classes="random"):
    pos = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    cls = (rng.integers(0, 6, n) if classes == "random"
           else np.floor(pos[:, 0] * 2) % 7).astype(np.uint8)
    return {POS: pos, INT: rng.integers(0, 65536, n).astype(np.uint16),
            CLS: cls, GPS: rng.uniform(0, 1e5, n)}


def _batches(cols, a, b, cap=CAP):
    """The rows [a, b) padded to ``cap`` as a JAX batch and the port's."""
    m = b - a
    c = {k: np.pad(v[a:b], [(0, cap - m)] + [(0, 0)] * (v.ndim - 1))
         for k, v in cols.items()}
    schema = JPointSchema.from_attributes(
        [x for n in NAMES for x in jatt.BUILTIN_ATTRIBUTES if x.name == n])
    jb = jdev.PointBatch({k: jnp.asarray(v) for k, v in c.items()},
                         jnp.asarray(m, jnp.int32), schema, {})
    pb = interop.batch_from_reference_arrays(
        {k: np.asarray(v) for k, v in jb.data.items()}, m, NAMES,
        device="cpu")
    return jb, pb


def _partials(cols, cuts, **kw):
    """Each chunk through both packages: [(JAX (batch, aux), port's)]."""
    out = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        jb, pb = _batches(cols, a, b)
        out.append((_jvox(tuple(sorted(kw.items())))(jb),
                    voxel_downsample(pb, LEAF, bounds=(torch.zeros(3), None),
                                     semantics="floor", with_aux=True, **kw)))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_aux(got, want, nv):
    """Keys, counts, mode statistics and run tables equal; raw means to
    f32 rounding."""
    want = _np(want)
    ref = interop.aux_to_reference(got)
    assert set(ref) == set(want)
    for i, k in enumerate(want["keys"]):
        np.testing.assert_array_equal(ref["keys"][i], k)
    np.testing.assert_array_equal(ref["counts"], want["counts"])
    for d in ("mode_counts", "mode2_values", "mode2_counts"):
        assert set(ref[d]) == set(want[d])
        for n in want[d]:
            np.testing.assert_array_equal(ref[d][n], want[d][n], err_msg=d)
    for n, m in want["raw_means"].items():
        np.testing.assert_allclose(ref["raw_means"][n][:nv], m[:nv],
                                   rtol=1e-6)
    for n, rt in want.get("mode_runs", {}).items():
        got_rt = ref["mode_runs"][n]
        for k in ("values", "counts", "num_runs"):
            np.testing.assert_array_equal(got_rt[k], rt[k], err_msg=k)
        for i, k in enumerate(rt["keys"]):
            np.testing.assert_array_equal(got_rt["keys"][i], k)
        if "input_truncated" in rt:
            assert bool(got_rt["input_truncated"]) == bool(
                rt["input_truncated"])


def _assert_batch(got, want, pos_atol=2e-5):
    nv = int(want.count)
    assert int(got.count) == nv > 0
    cols, _, _, _ = interop.batch_to_reference_arrays(got)
    np.testing.assert_allclose(cols[POS][:nv], np.asarray(want.data[POS])[:nv],
                               rtol=0, atol=pos_atol)
    np.testing.assert_array_equal(cols[CLS][:nv],
                                  np.asarray(want.data[CLS])[:nv])
    di = (cols[INT][:nv].astype(np.int64)
          - np.asarray(want.data[INT])[:nv].astype(np.int64))
    assert np.abs(di).max() <= 1
    np.testing.assert_allclose(cols[GPS][:nv], np.asarray(want.data[GPS])[:nv],
                               rtol=1e-6)
    return nv


@pytest.mark.parametrize("mode_runs", (False, True))
@pytest.mark.parametrize("grid_bits,sort_tiles", ((10, 8), (20, 1)))
def test_with_aux_matches_jax(rng, mode_runs, grid_bits, sort_tiles):
    """One partial's statistics, on single-u32 keys with tiled sorts and on
    dual keys with one sort, with and without run tables."""
    cols = _cloud(rng, 1000)
    ((jb, jaux), (pb, paux)), = _partials(
        cols, [0, 1000], grid_bits=grid_bits, sort_tiles=sort_tiles,
        mode_runs=mode_runs)
    nv = _assert_batch(pb, jb, pos_atol=1e-5)
    _assert_aux(paux, jaux, nv)
    assert len(paux["keys"]) == (1 if grid_bits <= 10 else 2)
    assert ("mode_runs" in paux) == mode_runs


@pytest.mark.parametrize("mode_runs", (False, True))
@pytest.mark.parametrize("cuts", ((0, 700, 1400), (0, 500, 1100, 1400)))
def test_merge_matches_jax(rng, mode_runs, cuts):
    """2 and 3 partials: the port's merge of its own partials, and of the
    JAX partials carried across, equals JAX's merge; the fold
    merge(merge(a, b), c) equals the flat merge."""
    cols = _cloud(rng, 1400)
    parts = _partials(cols, list(cuts), mode_runs=mode_runs)
    jm, jaux = _jmerge(())([p[0] for p in parts])
    pm, paux = merge_voxel_batches([p[1] for p in parts])
    nv = _assert_batch(pm, jm)
    _assert_aux(paux, jaux, nv)
    assert int(paux["counts"].sum()) == cuts[-1]
    carried = [(interop.batch_from_reference_arrays(
        {k: np.asarray(v) for k, v in jb.data.items()}, int(jb.count), NAMES,
        device="cpu"), interop.aux_from_reference(_np(ja), device="cpu"))
        for (jb, ja), _ in parts]
    cm, caux = merge_voxel_batches(carried)
    _assert_batch(cm, jm)
    _assert_aux(caux, jaux, nv)
    if len(parts) == 3:
        fm, faux = merge_voxel_batches(
            [merge_voxel_batches([p[1] for p in parts[:2]]), parts[2][1]])
        assert int(fm.count) == nv
        for name in (POS, GPS):
            np.testing.assert_allclose(fm.data[name][:nv].numpy(),
                                       pm.data[name][:nv].numpy(),
                                       rtol=1e-6, atol=1e-6)
        for k in ("counts",) + (("mode_counts",) if mode_runs else ()):
            a, b = faux[k], paux[k]
            if isinstance(a, dict):
                a, b = a[CLS], b[CLS]
            assert torch.equal(a, b)
        assert torch.equal(fm.data[CLS], pm.data[CLS]) or not mode_runs


def test_merge_equals_one_shot_with_run_tables(rng):
    """With run tables the merged mode equals the one-shot mode exactly on
    uniform-random labels; the run totals add up to the points."""
    cols = _cloud(rng, 1400)
    parts = _partials(cols, [0, 300, 900, 1400], mode_runs=True)
    merged, aux = merge_voxel_batches([p[1] for p in parts])
    _, one = _batches(cols, 0, 1400, cap=1400)
    one = voxel_downsample(one, LEAF, bounds=(torch.zeros(3), None),
                           semantics="floor")
    nv = int(one.count)
    assert int(merged.count) == nv
    assert torch.equal(merged.data[CLS][:nv], one.data[CLS][:nv])
    assert int(aux["mode_runs"][CLS]["counts"].sum()) == 1400
    assert not bool(aux["mode_runs"][CLS]["input_truncated"])


def _labeled(cells_labels, mode_runs=True, jax_too=False):
    """One point per (cell_x, label) entry in cell ``cell_x`` of a 1 m grid:
    the port's ``(batch, aux)``, and JAX's first where ``jax_too``."""
    m = len(cells_labels)
    pos = np.full((m, 3), 0.5, np.float32)
    pos[:, 0] += np.asarray([c for c, _ in cells_labels], np.float32)
    cols = {POS: pos, INT: np.zeros(m, np.uint16),
            CLS: np.asarray([lab for _, lab in cells_labels], np.uint8),
            GPS: np.zeros(m)}
    jb, pb = _batches(cols, 0, m, cap=8)
    port = voxel_downsample(pb, 1.0, semantics="floor",
                            bounds=(torch.zeros(3), None), with_aux=True,
                            mode_runs=mode_runs)
    if not jax_too:
        return port
    return _jvox((("mode_runs", mode_runs),), 1.0)(jb), port


def test_run_tables_beat_the_vote_and_cap():
    """The global mode ranks third in every partial: the top-2 vote misses
    it, the run tables elect it (as JAX's merge does); exact_mode is
    honoured; mode_runs_cap cuts the table and reports the true run count,
    and a generous cap keeps later folds exact."""
    chunks = [[5, 5, 5, 6, 6, 6, 9, 9], [7, 7, 7, 8, 8, 8, 9, 9],
              [3, 3, 3, 4, 4, 4, 9, 9]]
    both = [_labeled([(0, c) for c in ch], jax_too=True) for ch in chunks]
    exact = [p for _, p in both]
    vote = [_labeled([(0, c) for c in ch], mode_runs=False) for ch in chunks]
    pm, paux = merge_voxel_batches(exact)
    assert int(pm.data[CLS][0]) == 9 and int(paux["mode_counts"][CLS][0]) == 6
    rt = paux["mode_runs"][CLS]
    nr = int(rt["num_runs"])
    assert dict(zip(rt["values"][:nr].tolist(), rt["counts"][:nr].tolist())) \
        == {3: 3, 4: 3, 5: 3, 6: 3, 7: 3, 8: 3, 9: 6}
    _assert_aux(paux, _jmerge(())([j for j, _ in both])[1], 1)
    for parts, kw in ((vote, {}), (exact, {"exact_mode": False})):
        vm, vaux = merge_voxel_batches(parts, **kw)
        assert int(vm.data[CLS][0]) != 9 and "mode_runs" not in vaux
    with pytest.raises(ValueError, match="mode_runs"):
        merge_voxel_batches(vote, exact_mode=True)
    _, caux = merge_voxel_batches(exact, mode_runs_cap=4)
    assert caux["mode_runs"][CLS]["values"].shape[0] == 4
    assert int(caux["mode_runs"][CLS]["num_runs"]) == 7
    fold, _ = merge_voxel_batches(
        [merge_voxel_batches(exact[:2], mode_runs_cap=64), exact[2]])
    assert int(fold.data[CLS][0]) == 9


def test_truncated_run_table_stays_aligned_and_flags_the_fold():
    """A run table cut below its run count loses only its own voxel's
    votes in a later fold (rows stay aligned), and ``input_truncated``
    carries through every fold after it (the reference test's values)."""
    p1 = _labeled([(0, 1), (0, 1), (0, 2), (1, 3), (1, 3), (1, 4)])
    ptr = merge_voxel_batches([p1], mode_runs_cap=2)
    assert int(ptr[1]["mode_runs"][CLS]["num_runs"]) == 4
    assert ptr[1]["mode_runs"][CLS]["values"].shape[0] == 2
    assert not bool(ptr[1]["mode_runs"][CLS]["input_truncated"])
    pm, paux = merge_voxel_batches([ptr, _labeled([(0, 2), (0, 2)])])
    assert int(pm.count) == 2
    assert paux["counts"][:2].tolist() == [5, 3]
    np.testing.assert_allclose(pm.data[POS][:2, 0].numpy(), [0.5, 1.5],
                               atol=1e-6)
    assert pm.data[CLS][:2].tolist() == [2, 0]
    assert paux["mode_counts"][CLS][:2].tolist() == [3, 0]
    assert bool(paux["mode_runs"][CLS]["input_truncated"])
    _, paux2 = merge_voxel_batches([(pm, paux), _labeled([(0, 2)])])
    assert bool(paux2["mode_runs"][CLS]["input_truncated"])
