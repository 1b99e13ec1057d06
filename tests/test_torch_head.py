"""The pipeline head of pasture_tpu_torch (Morton coding, cell-base
coefficients, world bounds, exact-local voxel head) against the JAX
package: same numpy inputs, the port's plain versions on the CPU, the
Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu.math import morton as jmorton
from pasture_tpu.ops.kernels import fused_transform as jft

from pasture_tpu_torch.math import morton
from pasture_tpu_torch.ops import u32_carrier
from pasture_tpu_torch.ops.kernels import fused_transform as ft

T = torch.from_numpy


def _affine(theta=0.25, trans=(10.0, -5.0, 2.0)):
    scale = np.asarray([0.001, 0.001, 0.001], np.float32)
    rot = np.asarray([[np.cos(theta), -np.sin(theta), 0.0],
                      [np.sin(theta), np.cos(theta), 0.0],
                      [0.0, 0.0, 1.0]], np.float32)
    return scale, rot, np.asarray(trans, np.float32)


def points_off_cell_faces(rng, n, scale, rot, trans, bmin, leaf, semantics,
                          margin=1e-3, zrange=(0, 100_000)):
    """(n, 3) int32 locals whose world image lies at least ``margin`` leaves
    from every cell face (f64 check): a fused multiply-add on one side and
    separately rounded operations on the other then floor to the same cell."""
    out = []
    have = 0
    while have < n:
        loc = np.stack([rng.integers(0, 100_000, 2 * n),
                        rng.integers(0, 100_000, 2 * n),
                        rng.integers(zrange[0], zrange[1], 2 * n)],
                       axis=1).astype(np.int32)
        w = (loc.astype(np.float64) * scale.astype(np.float64)) \
            @ rot.astype(np.float64).T + trans.astype(np.float64)
        u = (w - bmin.astype(np.float64)) / leaf
        if semantics == "nearest":
            u = u - 0.5
        frac = u - np.floor(u)
        ok = np.all((frac > margin) & (frac < 1 - margin), axis=1)
        out.append(loc[ok])
        have += int(ok.sum())
    return np.concatenate(out)[:n]


def test_morton_matches_jax(rng):
    c = rng.integers(0, 1 << 20, (3, 5000)).astype(np.uint32)
    for fn in ("_expand10_u32", "_compact10_u32"):
        want = np.asarray(getattr(jmorton, fn)(jnp.asarray(c[0])))
        got = getattr(morton, fn)(T(c[0].astype(np.int64)))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    whi, wlo = jmorton.morton_encode_dual32(*(jnp.asarray(x) for x in c))
    ghi, glo = morton.morton_encode_dual32(*(T(x.astype(np.int64)) for x in c))
    np.testing.assert_array_equal(ghi.numpy().astype(np.uint32),
                                  np.asarray(whi))
    np.testing.assert_array_equal(glo.numpy().astype(np.uint32),
                                  np.asarray(wlo))
    # decode inverts encode, and equals the JAX decode
    dec = morton.morton_decode_u32(glo)
    for a in range(3):
        np.testing.assert_array_equal(dec[a].numpy(), c[a] & 1023)
        np.testing.assert_array_equal(
            dec[a].numpy().astype(np.uint32),
            np.asarray(jmorton.morton_decode_u32(wlo)[a]))
    # host helpers are the same functions
    np.testing.assert_array_equal(
        morton.morton_encode_u64(c[0], c[1], c[2]),
        jmorton.morton_encode_u64(c[0], c[1], c[2]))
    np.testing.assert_array_equal(morton.reverse_bits(c[0]),
                                  jmorton.reverse_bits(c[0]))


@pytest.mark.parametrize("semantics", ["floor", "nearest"])
def test_exact_local_max_leaf_and_contract(semantics):
    scale = np.asarray([0.001, 0.002, 0.0005], np.float32)
    want = jft.exact_local_max_leaf(scale, semantics)
    assert ft.exact_local_max_leaf(scale, semantics) == want
    assert ft.exact_local_max_leaf(T(scale), semantics) == want
    eye, zero = torch.eye(3), torch.zeros(3)
    ft.exact_local_base_coeffs(T(scale), eye, zero, zero, want * 0.999,
                               semantics=semantics)
    with pytest.raises(ValueError, match="exact_local_max_leaf"):
        ft.exact_local_base_coeffs(T(scale), eye, zero, zero, want * 1.01,
                                   semantics=semantics)


@pytest.mark.parametrize("semantics", ["floor", "nearest"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exact_local_base_coeffs_bit_equal(semantics, seed):
    rng = np.random.default_rng(seed)
    scale, rot, trans = _affine(theta=rng.uniform(0, 6.28),
                                trans=rng.uniform(-20, 20, 3))
    scale = scale * rng.uniform(0.5, 2.0, 3).astype(np.float32)
    bmin = rng.uniform(-100, 100, 3).astype(np.float32)
    leaf = float(rng.uniform(0.05, 0.15))
    want = np.asarray(jft.exact_local_base_coeffs(
        jnp.asarray(scale), jnp.asarray(rot), jnp.asarray(trans),
        jnp.asarray(bmin), leaf, semantics))
    got = ft.exact_local_base_coeffs(T(scale), T(rot), T(trans), T(bmin),
                                     leaf, semantics)
    assert got.dtype == torch.int32 and got.shape == (15,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_world_bounds_plain_matches_pallas_interpret(rng):
    n = 32768
    local = rng.integers(-50_000, 150_000, (n, 3)).astype(np.int32)
    scale = np.asarray([0.001, 0.002, 0.0005], np.float32)
    _, rot, _ = _affine(theta=0.7)
    trans = np.asarray([3.0, -8.0, 0.5], np.float32)
    wmn, wmx = jft.fused_world_bounds(
        jnp.asarray(local), jnp.asarray(scale), jnp.asarray(rot),
        jnp.asarray(trans), interpret=True)
    before = dict(ft.LAUNCHES)
    gmn, gmx = ft.fused_world_bounds(T(local), T(scale), T(rot), T(trans))
    assert ft.LAUNCHES == before      # CPU tensors launch nothing
    # the same f32 operations; XLA on the CPU may fuse a multiply-add where
    # the port rounds each operation: at most a few ulp of values ~200
    np.testing.assert_allclose(gmn.numpy(), np.asarray(wmn), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gmx.numpy(), np.asarray(wmx), rtol=0,
                               atol=1e-5)
    # ragged N: the port does not need the 32 768 multiple
    g2 = ft.fused_world_bounds(T(local[:1001]), T(scale), T(rot), T(trans))
    world = (local[:1001].astype(np.float32) * scale) @ rot.T + trans
    np.testing.assert_allclose(g2[0].numpy(), world.min(0), atol=1e-3)
    np.testing.assert_allclose(g2[1].numpy(), world.max(0), atol=1e-3)
    with pytest.raises(TypeError):
        ft.fused_world_bounds(T(local.astype(np.int64)), T(scale), T(rot),
                              T(trans))


@pytest.mark.parametrize("semantics,leaf", [("floor", 0.5),
                                            ("nearest", 0.25)])
def test_voxel_head_plain_matches_pallas_interpret(rng, semantics, leaf):
    n = 32768
    scale, rot, trans = _affine()
    bmin = np.asarray([-16.0, -6.0, 1.5], np.float32)
    local = points_off_cell_faces(rng, n, scale, rot, trans, bmin, leaf,
                                  semantics)
    coeffs = jft.exact_local_base_coeffs(
        jnp.asarray(scale), jnp.asarray(rot), jnp.asarray(trans),
        jnp.asarray(bmin), leaf, semantics)
    wkey, wrw = jft.fused_voxel_head_exact_local(
        jnp.asarray(local), jnp.asarray(scale), jnp.asarray(rot),
        jnp.asarray(trans), jnp.asarray(bmin), leaf, coeffs,
        semantics=semantics, interpret=True)
    # the JAX-made coefficients feed both
    gkey, grw = ft.fused_voxel_head_exact_local(
        T(local), T(scale), T(rot), T(trans), T(bmin), leaf,
        T(np.asarray(coeffs)), semantics=semantics)
    assert gkey.dtype == torch.int64 and grw.dtype == torch.int64
    np.testing.assert_array_equal(gkey.numpy().astype(np.uint32),
                                  np.asarray(wkey))
    np.testing.assert_array_equal(grw.numpy().astype(np.uint32),
                                  np.asarray(wrw))
    # residuals use the window, not its clipped edges
    r = np.stack([(grw.numpy() >> s) & 1023 for s in (20, 10, 0)])
    assert r.min() > 0 and r.max() < 1023
    assert len(np.unique(gkey.numpy())) > 1000
    with pytest.raises(ValueError, match="semantics"):
        ft.fused_voxel_head_exact_local(
            T(local), T(scale), T(rot), T(trans), T(bmin), leaf,
            T(np.asarray(coeffs)), semantics="round")


def test_world_bounds_parameters_host_or_tensor(rng):
    """The parameters reach the kernel as three contiguous f32 tensors on
    the points' device: numpy arrays, CPU tensors of any float dtype and a
    flat or (3, 3) rotation all give the same bounds; a wrong size
    raises."""
    local = rng.integers(-20_000, 20_000, (777, 3)).astype(np.int32)
    scale, rot, trans = _affine(theta=1.1, trans=(4.0, -2.5, 7.0))
    want = ft.fused_world_bounds(T(local), T(scale), T(rot), T(trans))
    for args in ((scale, rot, trans),
                 (scale.astype(np.float64), rot.reshape(9), list(trans)),
                 (T(scale).double(), T(rot).reshape(9), T(trans))):
        got = ft.fused_world_bounds(T(local), *args)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert torch.equal(g, w)
    s, r, t = ft._bounds_params(scale, rot, trans, torch.device("cpu"))
    assert [tuple(x.shape) for x in (s, r, t)] == [(3,), (9,), (3,)]
    assert all(x.dtype == torch.float32 and x.is_contiguous()
               for x in (s, r, t))
    with pytest.raises(ValueError, match="rotation"):
        ft.fused_world_bounds(T(local), scale, rot[:2], trans)
    with pytest.raises(ValueError, match="translation"):
        ft.fused_world_bounds(T(local), scale, rot, trans[:2])
