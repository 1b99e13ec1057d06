"""Registration of the port against the JAX package: SE(3), nearest
neighbours and Morton-window correspondences, on the same numpy inputs
(f64: the JAX package runs with x64 here)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pasture_tpu import registration as jreg

from pasture_tpu_torch.registration import se3_exp, se3_log, so3_exp, so3_log

# the modules (each package's ``icp`` attribute is the function)
jicp_mod = importlib.import_module("pasture_tpu.registration.icp")
icp_mod = importlib.import_module("pasture_tpu_torch.registration.icp")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_se3_matches_jax_and_round_trips(rng):
    """exp and log of both groups against JAX in f64, small angles (the
    series branches) included; log(exp(x)) = x."""
    phi = rng.normal(size=(64, 3)) * 0.8
    phi[:4] *= 1e-9
    xi = np.concatenate([rng.normal(size=(64, 3)), phi], axis=1)
    rot = so3_exp(_t(phi)).numpy()
    np.testing.assert_allclose(rot, np.asarray(jax.jit(jreg.so3_exp)(
        jnp.asarray(phi))), rtol=0, atol=1e-14)
    np.testing.assert_allclose(so3_log(_t(rot)).numpy(), phi, atol=1e-9)
    np.testing.assert_allclose(so3_log(_t(rot)).numpy(), np.asarray(
        jax.jit(jreg.so3_log)(jnp.asarray(rot))), rtol=0, atol=1e-12)
    r, t = se3_exp(_t(xi))
    jr, jt = jax.jit(jreg.se3_exp)(jnp.asarray(xi))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-14)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-13)
    back = se3_log(r, t).numpy()
    np.testing.assert_allclose(back, xi, atol=1e-9)
    np.testing.assert_allclose(back, np.asarray(jax.jit(jreg.se3_log)(
        jr, jt)), atol=1e-12)


def test_nearest_neighbors_match_jax(rng):
    """Indices equal on continuous f64 data, invalid targets skipped."""
    query = rng.uniform(0, 4, (700, 3))
    points = rng.uniform(0, 4, (900, 3))
    valid = rng.random(900) > 0.2
    idx, d2 = icp_mod.nearest_neighbors(_t(query), _t(points), _t(valid),
                                        tile=256)
    jidx, jd2 = jicp_mod.nearest_neighbors(
        jnp.asarray(query), jnp.asarray(points), jnp.asarray(valid), 256)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-12)
    assert valid[idx.numpy()].all()


def _surface(rng, n, size=6.0):
    u = rng.uniform(-size / 2, size / 2, (n, 2))
    z = 0.3 * np.sin(u[:, 0] * 2.0) + 0.2 * np.cos(u[:, 1] * 1.5)
    return np.stack([u[:, 0], u[:, 1], z], axis=1)


def test_morton_nearest_target_matches_jax(rng):
    """Matched positions, squared distances and matched normals of the valid
    source rows equal JAX's on continuous f64 data (distinct 20-bit cells:
    one co-sort order), some rows of both clouds invalid."""
    target = _surface(rng, 3000)
    moved = target[rng.permutation(3000)[:2000]] + rng.normal(
        0, 0.02, (2000, 3))
    sv = rng.random(2000) > 0.05
    tv = rng.random(3000) > 0.05
    nrm = rng.normal(size=(3000, 3))
    lo = target.min(axis=0)
    ext = target.max(axis=0) - lo
    got = icp_mod.morton_nearest_target(_t(moved), _t(sv), _t(target),
                                        _t(tv), _t(lo), _t(ext), 16,
                                        target_normals=_t(nrm))
    want = jicp_mod.morton_nearest_target(
        jnp.asarray(moved), jnp.asarray(sv), jnp.asarray(target),
        jnp.asarray(tv), jnp.asarray(lo), jnp.asarray(ext), 16,
        target_normals=jnp.asarray(nrm))
    # invalid source rows sort behind every valid row, in input order here
    # and in an unspecified order there; their matches are never used
    np.testing.assert_array_equal(got[0].numpy()[sv], np.asarray(want[0])[sv])
    np.testing.assert_allclose(got[1].numpy()[sv], np.asarray(want[1])[sv],
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(got[2].numpy()[sv], np.asarray(want[2])[sv])
    # without normals: the same match
    pos, d2 = icp_mod.morton_nearest_target(_t(moved), _t(sv), _t(target),
                                            _t(tv), _t(lo), _t(ext), 16)
    np.testing.assert_array_equal(pos.numpy(), got[0].numpy())
