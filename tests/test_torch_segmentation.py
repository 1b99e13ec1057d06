"""RANSAC segmentation and the convex hull of pasture_tpu_torch against the
JAX package on the same seeded numpy points.

* The serial (host) RANSAC variants give the same plane, line and inliers
  bit for bit.
* The device variants draw their hypotheses from a torch CPU generator, not
  JAX's ``randint`` stream, so the two packages score other hypotheses for
  the same seed.  What must agree is everything after the draw: the nudge
  that separates clashing indices (``_decollide`` against JAX's
  ``_sample_distinct`` on its own raw draw), and, given JAX's hypotheses,
  the winner, its count and its inlier mask, except for points whose f64
  distance lies within 1e-5 x threshold of the threshold (counted here).
* The convex hull gives the same triangles and vertex indices on the cases
  of tests/test_algorithms.py and a sample of tests/test_convexhull_battery.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu.algorithms import convexhull as jhull
from pasture_tpu.algorithms import segmentation as jseg
from pasture_tpu.buffers.host import HostPointBuffer as JHostPointBuffer
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.layout.schema import PointSchema as JPointSchema

from pasture_tpu_torch.algorithms import convexhull as phull
from pasture_tpu_torch.algorithms import segmentation as pseg
from pasture_tpu_torch.buffers import HostPointBuffer, PointBatch
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.dtypes import DevicePolicy
from pasture_tpu_torch.layout.schema import PointSchema

BAND = 1e-5                                   # of the threshold


def _pair(pos):
    pos = np.asarray(pos, np.float64).reshape(-1, 3)
    return (JHostPointBuffer.from_columns(
                JPointSchema.from_attributes([jatt.POSITION_3D]),
                {"Position3D": pos}),
            HostPointBuffer.from_columns(
                PointSchema.from_attributes([att.POSITION_3D]),
                {"Position3D": pos}))


def _plane_cloud(rng, n_plane=400, n_noise=60):
    """tests/test_algorithms.py's plane: z = 0.5x - 0.25y + 3 plus noise."""
    xy = rng.uniform(-10, 10, (n_plane, 2))
    plane_pts = np.stack([xy[:, 0], xy[:, 1],
                          0.5 * xy[:, 0] - 0.25 * xy[:, 1] + 3.0], axis=1)
    return np.concatenate([plane_pts, rng.uniform(-30, 30, (n_noise, 3))])


def _line_cloud(rng):
    """tests/test_algorithms.py's line: (t, 2t + 1, -t) plus noise."""
    t = rng.uniform(-10, 10, 300)
    line_pts = np.stack([t, 2 * t + 1, -t], axis=1)
    return np.concatenate([line_pts, rng.uniform(-30, 30, (50, 3))])


def _f64_distances(pos, sample, k):
    """The numpy oracle: f64 distances of every point to one hypothesis."""
    s = np.asarray(sample, np.float64)
    if k == 3:
        normal = np.cross(s[1] - s[0], s[2] - s[0])
        return jseg.Plane(*normal, -normal @ s[0]).distance(pos)
    return jseg.Line(s[0], s[1]).distance(pos)


# ---- host variants -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_serial_ransac_plane_is_bit_equal(seed):
    jbuf, pbuf = _pair(_plane_cloud(np.random.default_rng(seed)))
    jplane, jin = jseg.ransac_plane_serial(jbuf, 0.1, 48, seed=seed)
    pplane, pin = pseg.ransac_plane_serial(pbuf, 0.1, 48, seed=seed)
    assert (pplane.a, pplane.b, pplane.c, pplane.d, pplane.ranking) == \
        (jplane.a, jplane.b, jplane.c, jplane.d, jplane.ranking)
    np.testing.assert_array_equal(pin, jin)
    assert pseg.ransac_plane_par is pseg.ransac_plane_serial
    batch = PointBatch.from_host(pbuf, policy=DevicePolicy.EXACT,
                                 capacity=len(pbuf) + 5, device="cpu")
    bplane, bin_ = pseg.ransac_plane_serial(batch, 0.1, 48, seed=seed)
    assert bplane == pplane
    np.testing.assert_array_equal(bin_, pin)


@pytest.mark.parametrize("seed", [2, 3])
def test_serial_ransac_line_is_bit_equal(seed):
    jbuf, pbuf = _pair(_line_cloud(np.random.default_rng(seed)))
    jline, jin = jseg.ransac_line_serial(jbuf, 0.05, 48, seed=seed)
    pline, pin = pseg.ransac_line_par(pbuf, 0.05, 48, seed=seed)
    np.testing.assert_array_equal(pline.first, jline.first)
    np.testing.assert_array_equal(pline.second, jline.second)
    assert pline.ranking == jline.ranking
    np.testing.assert_array_equal(pin, jin)
    with pytest.raises(ValueError, match="at least 2 points"):
        pseg.ransac_line_serial(_pair([[0.0, 0.0, 0.0]])[1], 0.1, 4)


# ---- device variants -----------------------------------------------------------

@pytest.mark.parametrize("k,n,iters", [(3, 460, 128), (2, 350, 256),
                                       (3, 5, 128), (2, 2, 128)])
def test_decollide_equals_sample_distinct(k, n, iters):
    key = jax.random.PRNGKey(11)
    raw = np.asarray(jax.random.randint(key, (iters, k), 0, n))
    want = np.asarray(jseg._sample_distinct(key, iters, n, k))
    got = pseg._decollide(torch.from_numpy(raw.astype(np.int64)), n)
    np.testing.assert_array_equal(got.numpy(), want)
    if k == 2 and n >= 2:           # a 3-subset may keep a repeat, as in JAX
        assert (got[:, 0] != got[:, 1]).all()


@pytest.mark.parametrize("k,thr,dtype", [(3, 0.1, np.float32),
                                         (2, 0.05, np.float32),
                                         (3, 0.1, np.float64)])
def test_scorer_picks_the_jax_winner(k, thr, dtype):
    rng = np.random.default_rng(5)
    pos = (_plane_cloud(rng) if k == 3 else _line_cloud(rng)).astype(dtype)
    n, cap = len(pos), len(pos) + 12            # padded rows must not count
    padded = np.concatenate([pos, np.zeros((cap - n, 3), dtype)])
    mask = np.arange(cap) < n
    key = jax.random.PRNGKey(4)
    jsample, jcount, jinlier = jax.jit(
        jseg._ransac_device, static_argnums=(2, 4))(
        jnp.asarray(padded), jnp.asarray(mask), k, thr, 64, key)
    idx = np.asarray(jseg._sample_distinct(key, 128, n, k))

    tpos, tmask = torch.from_numpy(padded), torch.from_numpy(mask)
    samples = tpos[torch.from_numpy(idx.astype(np.int64))]
    counts = pseg._score_hypotheses(tpos, tmask, samples, k, thr).numpy()
    # every count equals the f64 recount but for the points in the band
    band_total = 0
    for h in range(len(idx)):
        d = _f64_distances(pos.astype(np.float64), padded[idx[h]], k)
        band = np.abs(d - thr) <= BAND * thr
        band_total += int(band.sum())
        assert abs(int(counts[h]) - int((d < thr).sum())) <= band.sum()
    sample, count, inlier = pseg._ransac_from_samples(
        tpos, tmask, samples, k, thr)
    np.testing.assert_array_equal(sample.numpy(), np.asarray(jsample))
    d = _f64_distances(pos.astype(np.float64), sample.numpy(), k)
    band = np.abs(d - thr) <= BAND * thr
    assert abs(count - int(jcount)) <= band.sum()
    differ = inlier.numpy()[:n] != np.asarray(jinlier)[:n]
    assert not (differ & ~band).any()
    assert not inlier.numpy()[n:].any()
    print(f"k={k}: {band_total} band points over all hypotheses, "
          f"{int(differ.sum())} inliers differ")


def test_device_ransac_plane_finds_the_plane():
    pos = _plane_cloud(np.random.default_rng(42))
    pbuf = _pair(pos)[1]
    batch = PointBatch.from_host(pbuf, capacity=512, device="cpu")
    plane, inliers = pseg.ransac_plane_device(batch, 0.1, 64, seed=1)
    assert plane.ranking >= 390
    assert plane.distance(pos[inliers]).max() < 0.1
    again = pseg.ransac_plane_device(pbuf, 0.1, 64, seed=1, device="cpu")
    assert again[0] == plane
    np.testing.assert_array_equal(again[1], inliers)


def test_device_ransac_line_finds_the_line():
    pos = _line_cloud(np.random.default_rng(42))
    batch = PointBatch.from_host(_pair(pos)[1], capacity=512, device="cpu")
    line, inliers = pseg.ransac_line_device(batch, 0.05, 64, seed=2)
    assert line.ranking >= 290
    assert line.distance(pos[inliers]).max() < 0.05 + 1e-5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=None means the GPU"):
            pseg.ransac_line_device(_pair(pos)[1], 0.05, 64)


# ---- convex hull ---------------------------------------------------------------

def _hull_cases():
    rng = np.random.default_rng(42)
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                        for z in (0, 1)], np.float64)
    t = np.linspace(0, 1, 7)
    sphere = rng.normal(size=(300, 3))
    sphere /= np.linalg.norm(sphere, axis=1, keepdims=True)
    box = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                    for z in (-1, 1)], np.float64)
    square = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                      np.float64)
    return {
        "cube_interior": np.concatenate(
            [corners, rng.uniform(0.1, 0.9, (50, 3))]),
        "normal_200": rng.normal(size=(200, 3)),
        "one_point": np.zeros((3, 3)),
        "collinear": np.stack([t, 2 * t, 3 * t], axis=1),
        "square_centre": np.concatenate([square, [[0.5, 0.5, 0.0]]]),
        "triangle": np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1]], np.float64),
        "tet_5": np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0],
                           [0.1, 0.1, 0.1]], np.float64),
        "box_first_3d": np.concatenate(
            [box, rng.uniform(-1, 1, (400, 3))]),
        "box_last_3d": np.concatenate(
            [rng.uniform(-1, 1, (400, 3)), box]),
        "points_2d_in_box": np.concatenate(
            [square * 2 - 1, np.c_[rng.uniform(-1, 1, (60, 2)),
                                   np.zeros(60)]]),
        "duplicates": np.repeat(rng.normal(size=(40, 3)), 5, axis=0),
        "sphere_surface": sphere,
        "large": rng.uniform(-1000, 1000, (2000, 3)),
    }


@pytest.mark.parametrize("case", list(_hull_cases()))
def test_convex_hull_matches_the_jax_package(case):
    pos = _hull_cases()[case]
    jbuf, pbuf = _pair(pos)
    for jfun, pfun in ((jhull.convex_hull_as_points,
                        phull.convex_hull_as_points),
                       (jhull.convex_hull_as_triangle_mesh,
                        phull.convex_hull_as_triangle_mesh)):
        try:
            want = jfun(jbuf)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                pfun(pbuf)
            continue
        got = pfun(pbuf)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    batch = PointBatch.from_host(pbuf, policy=DevicePolicy.EXACT,
                                 capacity=len(pos) + 3, device="cpu")
    np.testing.assert_array_equal(phull.convex_hull_as_points(batch),
                                  jhull.convex_hull_as_points(jbuf))


@pytest.mark.parametrize("k", [3, 2])
def test_chip_smoke_segmentation_rehearsal(k, monkeypatch):
    """``chip_smoke.py``'s path_segmentation gates at a small size on the
    CPU: counts against the f64 recount within the f32 bound, the winner's
    share of the scene, a second call, and the cross-check (here CPU
    against CPU)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "SEG_CROSS_N", 2048)
    scene = chip_smoke.plane_scene if k == 3 else chip_smoke.wire_scene
    pos, own = scene(20_000)
    gate = chip_smoke.gate_segmentation(pos, own, k, 128, 1, "cpu")
    assert gate["share_of_own_points"] >= 0.9
    cross = chip_smoke.cross_check_cpu(pos, k, 128, 1, "cpu")
    assert cross["max_count_diff"] == 0 and not cross["winners_differ"]
