"""ICP of the port against the JAX package on both correspondences
(exact, Morton window) and both objectives (point-to-point, point-to-plane
with target normals fitted inside), on the same numpy inputs (f64: the JAX
package runs with x64 here)."""

import doctest
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu import registration as jreg

from pasture_tpu_torch.registration import icp, so3_exp

# the module (the package's ``icp`` attribute is the function)
icp_mod = importlib.import_module("pasture_tpu_torch.registration.icp")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _jit_icp(static):
    def run(source, target):
        r = jreg.icp(source, target, **dict(static))
        return r.rotation, r.translation, r.rmse, r.num_inliers
    return jax.jit(run)


def _jax_icp(source, target, **kw):
    """JAX ``icp`` as one ``jax.jit`` program (compiled once instead of op
    by op), except on the Morton point-to-plane path, whose window-fit
    normals compile far slower as one program than op by op."""
    if kw["correspondence"] == "morton" and kw["point_to_plane"]:
        r = jreg.icp(source, target, **kw)
        return r.rotation, r.translation, r.rmse, r.num_inliers
    return _jit_icp(tuple(sorted(kw.items())))(source, target)


def _surface(rng, n, size=6.0):
    u = rng.uniform(-size / 2, size / 2, (n, 2))
    z = 0.3 * np.sin(u[:, 0] * 2.0) + 0.2 * np.cos(u[:, 1] * 1.5)
    return np.stack([u[:, 0], u[:, 1], z], axis=1)


@pytest.mark.parametrize("correspondence", ["exact", "morton"])
@pytest.mark.parametrize("point_to_plane", [False, True])
def test_icp_matches_jax(rng, correspondence, point_to_plane):
    """The pose after 10 iterations within 1e-6 of JAX's (f64; the same
    steps but for summation order, and on the Morton point-to-plane path
    target normals from the port's query-frame window fit against JAX's
    absolute-moment XLA fit), inliers equal; both recover the shift."""
    target = _surface(rng, 1500)
    t_true = np.array([0.1, -0.08, 0.05])
    phi = np.array([0.0, 0.0, 0.02])
    rot_true = so3_exp(_t(phi)).numpy()
    source = (target - t_true) @ rot_true
    kw = dict(max_correspondence_distance=2.0, iterations=10,
              point_to_plane=point_to_plane, correspondence=correspondence,
              window=16)
    got = icp(_t(source), _t(target), **kw)
    rot, t, rmse, nin = _jax_icp(jnp.asarray(source), jnp.asarray(target),
                                 **kw)
    tol = 1e-6 if correspondence == "exact" or not point_to_plane else 1e-4
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(rot),
                               atol=tol)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(t),
                               atol=tol)
    assert int(got.num_inliers) == int(nin)
    # the residual after convergence is ~1e-9: rounding noise
    np.testing.assert_allclose(float(got.rmse), float(rmse), rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose(got.translation.numpy(), t_true, atol=1e-2)


@pytest.mark.parametrize("point_to_plane", [False, True])
def test_icp_float32_exact_matches_jax(rng, point_to_plane):
    """On float32 CPU tensors the exact path runs K8's plain version (what
    the card's kernels equal bit for bit): its pose after 10 iterations
    within 1e-6 of JAX's (f64) on the same float32 inputs, inliers equal,
    the rmse at float32 rounding of JAX's, the shift recovered."""
    target = _surface(rng, 1500).astype(np.float32)
    t_true = np.array([0.1, -0.08, 0.05])
    phi = np.array([0.0, 0.0, 0.02])
    rot_true = so3_exp(_t(phi)).numpy()
    source = ((target - t_true) @ rot_true).astype(np.float32)
    kw = dict(max_correspondence_distance=2.0, iterations=10,
              point_to_plane=point_to_plane, correspondence="exact",
              window=16)
    got = icp(_t(source), _t(target), **kw)
    assert got.rotation.dtype == torch.float32
    rot, t, rmse, nin = _jax_icp(jnp.asarray(source, dtype=jnp.float64),
                                 jnp.asarray(target, dtype=jnp.float64),
                                 **kw)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(rot),
                               atol=1e-6)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(t),
                               atol=1e-6)
    assert int(got.num_inliers) == int(nin)
    # the moved points' float32 rounding: a few units of 2**-24 x |p|
    np.testing.assert_allclose(float(got.rmse), float(rmse), rtol=0,
                               atol=4 * 2.0 ** -24 * np.abs(target).max())
    np.testing.assert_allclose(got.translation.numpy(), t_true, atol=1e-2)


def test_icp_rejects_unknown_correspondence():
    with pytest.raises(ValueError, match="unknown correspondence"):
        icp(torch.zeros((8, 3)), torch.zeros((8, 3)),
            correspondence="kdtree")


def test_icp_docstring_example():
    failures, _ = doctest.testmod(icp_mod)
    assert failures == 0
