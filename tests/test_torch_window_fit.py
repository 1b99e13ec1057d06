"""K6 window_fit_moments of the port against the JAX package: the plain
version (what a CPU tensor runs, and what the CUDA kernel equals bit for bit
on the card) against the Pallas kernel in interpret mode and against a
numpy sliding-window oracle; the port's ``window_fit`` against the JAX
``window_fit`` on both of its paths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu.algorithms import normals as jnormals
from pasture_tpu.ops.kernels.window_fit_kernel import (
    WINDOW_BLOCK, window_fit_moments_pallas)

from pasture_tpu_torch.algorithms import normals
from pasture_tpu_torch.ops import kernels
from pasture_tpu_torch.ops.kernels import window_fit_kernel as wf


def _window_inputs(rng, n, w, invalid=0.02, scale=30.0):
    """f32 queries and their (n + 2w, 3) candidate array, ``invalid`` of
    the candidates inf."""
    pos = rng.uniform(0, scale, (n, 3)).astype(np.float32)
    validc = rng.random(n) > invalid
    ppc = np.where(validc[:, None], pos, np.inf).astype(np.float32)
    pad = np.full((w, 3), np.inf, np.float32)
    return pos, np.concatenate([pad, ppc, pad])


def _port(sp, pp, k, w):
    return [t.numpy() for t in kernels.window_fit_moments(
        torch.from_numpy(sp), torch.from_numpy(pp), k, w)]


def test_plain_matches_pallas_interpret_across_blocks(rng):
    """Across the 32 768-row block of the TPU kernel, with 2 % inf
    candidates: count exact; sums at the reference test's tolerances."""
    k, w = 4, 8
    n = WINDOW_BLOCK + WINDOW_BLOCK // 4 + 7
    sp, pp = _window_inputs(rng, n, w)
    want = [np.asarray(a) for a in window_fit_moments_pallas(
        jnp.asarray(sp), jnp.asarray(pp), k=k, w=w, interpret=True)]
    cnt, tight, s, m6 = _port(sp, pp, k, w)
    np.testing.assert_array_equal(cnt, want[0])
    np.testing.assert_allclose(tight, want[1], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s, want[2], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(m6, want[3], rtol=1e-4, atol=1e-3)


def _oracle(sp, pp, k, w):
    """numpy sliding-window oracle of tests/test_pallas_kernels.py, in f64
    on the f32 inputs, with the kernel's 1e-6 threshold margin."""
    win = np.lib.stride_tricks.sliding_window_view(
        pp.astype(np.float64), 2 * w + 1, axis=0)      # (n, 3, 2w+1)
    d = win - sp.astype(np.float64)[:, :, None]
    d2 = np.einsum("nci,nci->ni", d, d)
    thr = np.sort(d2, axis=1)[:, k - 1] * (1 + 1e-6)
    sel = (d2 <= thr[:, None]) & np.isfinite(win[:, 0, :])
    dq = np.where(sel[:, None, :], d, 0.0)
    pairs = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
    return (sel.sum(axis=1), np.where(sel, d2, 0).sum(axis=1),
            dq.sum(axis=2),
            np.stack([(dq[:, a] * dq[:, b]).sum(axis=1) for a, b in pairs],
                     axis=1))


@pytest.mark.parametrize("k", [1, 12, 32])
def test_plain_matches_numpy_oracle(rng, k):
    """At the smoke run's window (w = 64) and k = 1, 12 (the smoke's k, the
    16-register instance) and 32 (the largest)."""
    w, n = 64, 3000
    sp, pp = _window_inputs(rng, n, w, scale=5.0)
    cnt, tight, s, m6 = _port(sp, pp, k, w)
    ocnt, otight, os_, om6 = _oracle(sp, pp, k, w)
    np.testing.assert_array_equal(cnt, ocnt)
    np.testing.assert_allclose(tight, otight, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s, os_, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(m6, om6, rtol=1e-4, atol=1e-3)


def test_ties_and_empty_windows():
    """Ties at the k-th distance are all admitted; a query whose window has
    no finite candidate selects nothing (threshold inf, finite guard)."""
    w, k = 2, 2
    sp = np.zeros((3, 3), np.float32)
    cand = np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1], [np.inf] * 3,
                       [np.inf] * 3], np.float32)
    # query 0 sees rows 0..4: three candidates at d2 = 1 tie for the 2nd
    pp = np.concatenate([cand, np.full((2, 3), np.inf, np.float32)])
    cnt, tight, s, _ = _port(sp, pp, k, w)
    assert cnt[0] == 3 and tight[0] == 3.0
    np.testing.assert_array_equal(s[0], [1, 1, 1])
    assert cnt[2] == 1 and cnt[1] == 2
    empty = np.full((1 + 2 * w, 3), np.inf, np.float32)
    cnt, tight, s, m6 = _port(sp[:1], empty, k, w)
    assert cnt[0] == 0 and tight[0] == 0 and not s.any() and not m6.any()


def test_wrapper_contract():
    """What the kernel takes; CPU tensors run the plain version (no launch
    counted); bad shapes raise."""
    assert wf.supports_window_fit(1 << 21, 12, 64, torch.float32)
    assert wf.supports_window_fit(10, 32, 1920, torch.float32)
    assert not wf.supports_window_fit(10, 33, 64, torch.float32)
    assert not wf.supports_window_fit(10, 12, 1921, torch.float32)
    assert not wf.supports_window_fit(10, 12, 64, torch.float64)
    assert not wf.supports_window_fit(10, 12, 0, torch.float32)
    kernels.reset_launch_counts()
    sp = torch.zeros((4, 3))
    kernels.window_fit_moments(sp, torch.zeros((8, 3)), 2, 2)
    assert kernels.launch_counts()["window_fit_moments"] == 0
    with pytest.raises(ValueError, match="n \\+ 2w"):
        kernels.window_fit_moments(sp, torch.zeros((7, 3)), 2, 2)


def _sorted_surface(rng, n, w):
    """Points of a smooth surface in Morton order, as window_fit sees them."""
    xy = rng.uniform(-10, 10, (n, 2))
    z = 0.4 * np.sin(0.7 * xy[:, 0]) + 0.3 * np.cos(0.5 * xy[:, 1])
    pos = torch.from_numpy(np.stack([xy[:, 0], xy[:, 1], z],
                                    axis=1).astype(np.float32))
    valid = torch.ones(n, dtype=torch.bool)
    lo = pos.amin(dim=0)
    perm = normals.morton_order(pos, valid, lo, (pos.amax(dim=0) - lo).max())
    sp = pos[perm].numpy()
    pad = np.full((w, 3), np.inf, np.float32)
    return sp, np.concatenate([pad, sp, pad])


def _angles(a, b):
    """Angles between unoriented normals, in radians (f64, by atan2 so that
    nearly parallel f32 vectors do not read arccos's rounding)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    return np.arctan2(np.linalg.norm(np.cross(a, b), axis=1),
                      np.abs(np.sum(a * b, axis=1)))


def test_window_fit_matches_jax_window_fit(rng):
    """The port's window_fit (K6 formulation) against the JAX window_fit on
    both of its CPU paths: the Pallas kernel forced on (interpret mode, the
    same formulation) and the default XLA path (absolute moments, no
    threshold margin).  Tolerances: the same formulation agrees to f32
    rounding (XLA may contract a multiply-add the port rounds twice): 1e-5
    rad for 99.9 % of normals; the XLA path's absolute second moments lose
    ~|x|²·eps to cancellation: 1e-3 rad for 99 %, 1e-2 for all."""
    k, w, n = 8, 8, 4000
    sp, pp = _sorted_surface(rng, n, w)
    got_n, got_c, got_t = [t.numpy() for t in normals.window_fit(
        torch.from_numpy(sp), torch.from_numpy(pp), k, w)]
    jnormals._FORCE_WINDOW_KERNEL = True
    try:
        kn, kc, kt = [np.asarray(a) for a in jnormals.window_fit(
            jnp.asarray(sp), jnp.asarray(pp), k, w)]
    finally:
        jnormals._FORCE_WINDOW_KERNEL = None
    xn, xc, xt = [np.asarray(a) for a in jnormals.window_fit(
        jnp.asarray(sp), jnp.asarray(pp), k, w)]
    ak = _angles(got_n, kn)
    assert np.percentile(ak, 99.9) < 1e-5 and ak.max() < 1e-3
    np.testing.assert_allclose(got_c, kc, atol=1e-5)
    np.testing.assert_allclose(got_t, kt, rtol=1e-5, atol=1e-7)
    ax = _angles(got_n, xn)
    assert np.percentile(ax, 99) < 1e-3 and ax.max() < 1e-2
    np.testing.assert_allclose(got_c, xc, atol=2e-4)
    np.testing.assert_allclose(got_t, xt, rtol=1e-5, atol=1e-7)
