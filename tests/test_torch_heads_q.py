"""The quantized voxel head and the decode + transform + key head of
pasture_tpu_torch against the JAX package: same numpy inputs, the port's
plain versions on the CPU, the Pallas kernels in interpret mode.

XLA on the CPU may fuse a multiply-add where the port rounds every
operation, so a coordinate can differ in its last bit and a ``floor`` on a
face can flip.  Keys are therefore compared on points that keep 1e-3 leaf
away from every cell face, and residual words on points that also keep a
tenth of a residual step away from every step boundary (both checked in
f64: a step of 1/1024 leaf is ~65 ulp of a grid coordinate of 250, and
either side may be a few ulp from the f64 value)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu.ops.kernels import fused_transform as jft

from pasture_tpu_torch import interop
from pasture_tpu_torch.ops.kernels import fused_transform as ft

T = torch.from_numpy

N = 32768        # the Pallas heads take multiples of 32 768 points
SCALE = np.asarray([0.001, 0.001, 0.001], np.float32)
ROT = np.asarray([[np.cos(0.25), -np.sin(0.25), 0.0],
                  [np.sin(0.25), np.cos(0.25), 0.0],
                  [0.0, 0.0, 1.0]], np.float32)
TRANS = np.asarray([5.0, -2.0, 1.0], np.float32)
BMIN = np.asarray([-20.0, -3.0, 0.5], np.float32)


def _grid_f64(local, leaf):
    w = (local.astype(np.float64) * SCALE.astype(np.float64)) \
        @ ROT.astype(np.float64).T + TRANS.astype(np.float64)
    return (w - BMIN.astype(np.float64)) / leaf


def _off_faces(rng, leaf, semantics, qbits=None, n=N):
    """(n, 3) int32 locals off every cell face, and with ``qbits`` off every
    residual step boundary too."""
    out, have = [], 0
    while have < n:
        loc = rng.integers(0, 100_000, (4 * n, 3)).astype(np.int32)
        u = _grid_f64(loc, leaf)
        shifted = u - 0.5 if semantics == "nearest" else u
        frac = shifted - np.floor(shifted)
        ok = np.all((frac > 1e-3) & (frac < 1 - 1e-3), axis=1)
        if qbits is not None:
            window = 1.5 if semantics == "nearest" else 1.0
            cell = np.clip(np.floor(shifted), 0, 1023)
            r = (u - cell) * ((1 << qbits) / window)
            fr = r - np.floor(r)
            ok &= np.all((fr > 0.1) & (fr < 0.9), axis=1)
        out.append(loc[ok])
        have += int(ok.sum())
    return np.concatenate(out)[:n]


def _jargs(local, leaf):
    return (jnp.asarray(local), jnp.asarray(SCALE), jnp.asarray(ROT),
            jnp.asarray(TRANS), jnp.asarray(BMIN), leaf)


def _pargs(local, leaf):
    return (T(local),) + interop.head_args_from_reference(
        SCALE, ROT, TRANS, BMIN, leaf, device="cpu")


@pytest.mark.parametrize("semantics,leaf,qbits", [
    ("floor", 0.5, 10), ("nearest", 0.5, 10), ("floor", 0.25, 8),
    ("nearest", 0.25, 7)])
def test_voxel_head_plain_matches_pallas_interpret(rng, semantics, leaf,
                                                   qbits):
    local = _off_faces(rng, leaf, semantics, qbits)
    wkey, wq = jft.fused_voxel_head(*_jargs(local, leaf), qbits=qbits,
                                    semantics=semantics, interpret=True)
    before = dict(ft.LAUNCHES)
    gkey, gq = ft.fused_voxel_head(*_pargs(local, leaf), qbits=qbits,
                                   semantics=semantics)
    assert ft.LAUNCHES == before          # CPU tensors launch nothing
    assert gkey.dtype == torch.int64 and gq.dtype == torch.int64
    np.testing.assert_array_equal(gkey.numpy().astype(np.uint32),
                                  np.asarray(wkey))
    np.testing.assert_array_equal(gq.numpy().astype(np.uint32),
                                  np.asarray(wq))
    # the residuals use their window and fit their bits
    q = np.stack([(gq.numpy() >> s) & ((1 << qbits) - 1)
                  for s in (2 * qbits, qbits, 0)])
    assert gq.numpy().max() < 1 << (3 * qbits)
    assert q.max() == (1 << qbits) - 1 or q.max() > 0.95 * (1 << qbits)
    if semantics == "nearest":
        # window [0.5, 1.5) of 1.5 leaves inside the grid: no residual in
        # the lowest third
        assert q.min() >= (1 << qbits) // 3 - 1
    assert len(np.unique(gkey.numpy())) > 1000


def test_voxel_head_saturates_beyond_the_grid(rng):
    """A point past the 1024-cell grid keeps the clipped cell and a
    saturated residual; one below it gets cell 0 and residual 0."""
    leaf = 0.01                            # the grid spans 10.24 m
    local = rng.integers(-100_000, 100_000, (1001, 3)).astype(np.int32)
    key, q = ft.fused_voxel_head(*_pargs(local, leaf), qbits=10,
                                 semantics="floor")
    u = _grid_f64(local, leaf)
    far = np.all(u > 1025, axis=1)
    below = np.all(u < -1, axis=1)
    assert far.any() and below.any()
    assert np.all(q.numpy()[far] == (1023 << 20 | 1023 << 10 | 1023))
    assert np.all(key.numpy()[far] == (1 << 30) - 1)
    assert np.all(q.numpy()[below] == 0) and np.all(key.numpy()[below] == 0)


def test_decode_transform_key_plain_matches_pallas_interpret(rng):
    leaf = 0.25
    local = _off_faces(rng, leaf, "floor")
    wworld, wkey = jft.fused_decode_transform_key(*_jargs(local, leaf),
                                                  interpret=True)
    before = dict(ft.LAUNCHES)
    gworld, gkey = ft.fused_decode_transform_key(*_pargs(local, leaf))
    assert ft.LAUNCHES == before
    assert gworld.shape == (N, 3) and gworld.dtype == torch.float32
    assert gkey.dtype == torch.int64
    np.testing.assert_array_equal(gkey.numpy().astype(np.uint32),
                                  np.asarray(wkey))
    # tests/test_pallas_kernels.py holds the JAX kernel to the same bound
    np.testing.assert_allclose(gworld.numpy(), np.asarray(wworld), rtol=1e-5,
                               atol=1e-3)
    # and in fact only a fused multiply-add apart: an ulp of values ~100
    np.testing.assert_allclose(gworld.numpy(), np.asarray(wworld), rtol=0,
                               atol=2e-5)
    # ragged N: the port needs no 32 768 multiple
    w2, k2 = ft.fused_decode_transform_key(*_pargs(local[:1001], leaf))
    assert torch.equal(w2, gworld[:1001]) and torch.equal(k2, gkey[:1001])
    # the exact-local head makes the same key from the same points
    coeffs = ft.exact_local_base_coeffs(T(SCALE), T(ROT), T(TRANS), T(BMIN),
                                        leaf, "floor")
    k3, _ = ft.fused_voxel_head_exact_local(*_pargs(local, leaf), coeffs)
    assert torch.equal(k3, gkey)


def test_head_argument_errors(rng):
    local = rng.integers(0, 1000, (16, 3)).astype(np.int32)
    args = _pargs(local, 0.5)
    for qbits in (0, 11):
        with pytest.raises(ValueError, match="qbits"):
            ft.fused_voxel_head(*args, qbits=qbits)
    with pytest.raises(ValueError, match="semantics"):
        ft.fused_voxel_head(*args, semantics="round")
    bad = (T(local.astype(np.int64)),) + args[1:]
    with pytest.raises(TypeError):
        ft.fused_voxel_head(*bad)
    with pytest.raises(TypeError):
        ft.fused_decode_transform_key(*bad)
    # an empty batch gives empty outputs
    empty = (T(local[:0]),) + args[1:]
    key, q = ft.fused_voxel_head(*empty)
    world, k2 = ft.fused_decode_transform_key(*empty)
    assert key.shape == q.shape == k2.shape == (0,)
    assert world.shape == (0, 3)
