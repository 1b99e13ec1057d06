"""Normals of the port against the JAX package: the closed-form 3x3
eigensolve, k-NN indices, exact normals, and ``compute_normals`` on both of
its paths, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pasture_tpu.buffers.device as jdev
from pasture_tpu.algorithms import normals as jnormals
from pasture_tpu.buffers.host import HostPointBuffer as JHostPointBuffer
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.layout.schema import PointSchema as JPointSchema

from pasture_tpu_torch.algorithms import (compute_centroid, compute_normals,
                                          knn_indices, normals)
from pasture_tpu_torch.buffers import HostPointBuffer, PointBatch
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.schema import PointSchema


def _angles(a, b):
    """Angles between unoriented normals, in radians (f64, atan2)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    return np.arctan2(np.linalg.norm(np.cross(a, b), axis=1),
                      np.abs(np.sum(a * b, axis=1)))


def _buffers(pos):
    """The same positions as a host buffer of each package."""
    port = HostPointBuffer(PointSchema.from_attributes([att.POSITION_3D]),
                           {att.POSITION_3D.name: pos})
    ref = JHostPointBuffer(JPointSchema.from_attributes([jatt.POSITION_3D]),
                           {jatt.POSITION_3D.name: pos})
    return port, ref


def _surface(rng, n, size=10.0):
    xy = rng.uniform(0, size, (n, 2))
    z = 0.3 * np.sin(xy[:, 0]) + 0.2 * np.cos(1.3 * xy[:, 1])
    return np.stack([xy[:, 0], xy[:, 1], z], axis=1)


def test_eigh3_smallest_matches_jax(rng):
    """Random symmetric positive semi-definite matrices in f64, and an
    isotropic one (the +z fallback)."""
    a = rng.normal(size=(500, 3, 3))
    cov = np.einsum("nij,nkj->nik", a, a)
    cov[0] = 2.0 * np.eye(3)
    lam, vec = [t.numpy() for t in normals._eigh3_smallest(
        torch.from_numpy(cov))]
    jlam, jvec = [np.asarray(x) for x in jax.jit(
        jnormals._eigh3_smallest)(jnp.asarray(cov))]
    np.testing.assert_allclose(lam, jlam, rtol=1e-9, atol=1e-9)
    assert _angles(vec, jvec).max() < 1e-7
    np.testing.assert_array_equal(vec[0], [0.0, 0.0, 1.0])
    np.testing.assert_allclose(lam[1:], np.linalg.eigvalsh(cov[1:])[:, 0],
                               rtol=1e-7, atol=1e-7)


def test_knn_indices_match_jax_as_sets(rng):
    """Continuous f64 data (no distance ties), some rows invalid, tiles
    smaller than the cloud: each row's neighbour set equals JAX's."""
    pos = rng.uniform(0, 5, (1500, 3))
    valid = rng.random(1500) > 0.1
    got = knn_indices(torch.from_numpy(pos), torch.from_numpy(valid), 8,
                      tile=512).numpy()
    want = np.asarray(jax.jit(jnormals.knn_indices, static_argnums=(2, 3))(
        jnp.asarray(pos), jnp.asarray(valid), 8, 512))
    np.testing.assert_array_equal(np.sort(got, axis=1),
                                  np.sort(want, axis=1))
    assert valid[got].all()


def test_normals_device_matches_jax(rng):
    """Exact k-NN normals and curvature in f64."""
    pos = _surface(rng, 1200)
    valid = np.ones(1200, bool)
    n, c = [t.numpy() for t in normals._normals_device(
        torch.from_numpy(pos), torch.from_numpy(valid), 10, 512)]
    jn, jc = [np.asarray(x) for x in jax.jit(
        jnormals._normals_device, static_argnums=(2, 3))(
        jnp.asarray(pos), jnp.asarray(valid), 10, 512)]
    assert _angles(n, jn).max() < 1e-8
    np.testing.assert_allclose(c, jc, atol=1e-10)


def test_compute_normals_exact_matches_jax(rng):
    """``auto`` at 2000 points runs the exact path; both packages in f32
    (the JAX batch narrows positions to f32 as the port does).  Tolerance:
    f32 rounding of the distance matmul and of the covariance, 1e-3 rad for
    99 % of normals."""
    pos = _surface(rng, 2000)
    port, ref = _buffers(pos)
    n, c = compute_normals(port, 12, device="cpu")
    jn, jc = [np.asarray(x) for x in jnormals.compute_normals(
        jdev.PointBatch.from_host(ref), 12)]
    ang = _angles(n, jn)
    assert np.percentile(ang, 99) < 1e-3 and ang.max() < 2e-2
    np.testing.assert_allclose(c, jc, atol=1e-3)
    assert n.shape == (2000, 3) and c.shape == (2000,)
    # a batch of the same points gives the same answer as the host buffer
    bn, bc = compute_normals(PointBatch.from_host(port, device="cpu"), 12)
    np.testing.assert_array_equal(bn, n)
    np.testing.assert_array_equal(bc, c)


def test_compute_normals_morton_matches_jax(rng):
    """``method="morton"`` at 20 000 continuous points (no two share a
    20-bit cell, so both sorts give one order), both in f32.  The JAX CPU
    path accumulates absolute second moments with no threshold margin, the
    port query-frame moments with the K6 kernel's margin; the absolute
    moments lose ~|x|²·eps of the neighbourhood variance: 2e-3 rad for 99 %
    of normals, 2e-2 for all, curvature within 1e-3."""
    pos = _surface(rng, 20000)
    pos[:, :2] -= 5.0
    port, ref = _buffers(pos)
    n, c = compute_normals(port, 10, method="morton", window=12,
                           device="cpu")
    jn, jc = [np.asarray(x) for x in jnormals.compute_normals(
        jdev.PointBatch.from_host(ref), 10, method="morton", window=12)]
    ang = _angles(n, jn)
    assert np.percentile(ang, 99) < 2e-3 and ang.max() < 2e-2
    np.testing.assert_allclose(c, jc, atol=1e-3)


def test_compute_normals_plane_and_centroid(rng):
    """Points of the z = 0 plane get ±z normals and zero curvature on both
    paths; the centroid is the f64 mean."""
    pos = np.concatenate([rng.uniform(0, 10, (512, 2)),
                          np.zeros((512, 1))], axis=1)
    port, ref = _buffers(pos)
    for method in ("exact", "morton"):
        n, c = compute_normals(port, 8, method=method, window=16,
                               device="cpu")
        np.testing.assert_allclose(np.abs(n[:, 2]), 1.0, atol=1e-5)
        np.testing.assert_allclose(c, 0.0, atol=1e-5)
    np.testing.assert_allclose(compute_centroid(port),
                               jnormals.compute_centroid(ref), rtol=1e-12)
    batch = PointBatch.from_host(port, device="cpu")
    np.testing.assert_allclose(compute_centroid(batch),
                               pos.astype(np.float32).astype(
                                   np.float64).mean(axis=0), rtol=1e-12)


def test_compute_normals_validation(rng):
    """The reference's errors."""
    port, _ = _buffers(rng.uniform(0, 1, (64, 3)))
    small, _ = _buffers(rng.uniform(0, 1, (2, 3)))
    with pytest.raises(ValueError, match="too small"):
        compute_normals(small, 3, device="cpu")
    with pytest.raises(ValueError, match="k nearest"):
        compute_normals(port, 2, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        compute_normals(port, 3, method="kdtree", device="cpu")
    with pytest.raises(ValueError, match="window"):
        compute_normals(port, 12, method="morton", window=8, device="cpu")
