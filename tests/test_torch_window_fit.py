"""K6 window_fit_moments of the port against the JAX package: the plain
version (what a CPU tensor runs, and what the CUDA kernel equals bit for bit
on the card) against the Pallas kernel in interpret mode and against a
numpy sliding-window oracle; the port's ``window_fit`` against the JAX
``window_fit`` on both of its paths; and a model of the CUDA kernel's
schedule (centre-out guarded insertion, selected-only accumulation)
against the plain version, bit for bit."""

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


def _hard_inputs(rng, w):
    """f32 ``(sp, pp)`` of 300 queries built to break a schedule that is
    not exact: points of a coarse lattice (ties at the k-th distance) with
    a tenth of them duplicates of their predecessor; points within 3e-23 of
    the origin (offset products underflow to -0.0 and +0.0); a run of
    ``2w + 3`` invalid candidates (empty windows); 2 % invalid elsewhere."""
    lat = rng.integers(0, 3, (140, 3)).astype(np.float32)
    dup = np.flatnonzero(rng.random(140) < 0.1)
    dup = dup[dup > 0]
    lat[dup] = lat[dup - 1]
    tiny = rng.uniform(-3e-23, 3e-23, (140, 3)).astype(np.float32)
    sp = np.concatenate([lat, tiny, lat[:20]])
    cand = np.where(rng.random((300, 1)) < 0.02, np.inf, sp)
    cand[150:150 + 2 * w + 3] = np.inf
    pad = np.full((w, 3), np.inf, np.float32)
    return sp, np.concatenate([pad, cand, pad]).astype(np.float32)


def _schedule_model(sp, pp, k, w, q):
    """The CUDA kernel's schedule for the query in slot ``q`` of its thread,
    in plain PyTorch: pass 1 visits the thread's ``2w + 2`` strip rows
    centre-out (row ``j`` is shift ``j - q``) and inserts a candidate only
    where it is below the k-th register; pass 2 walks the shifts in
    ascending order and adds to the accumulators only where a candidate is
    selected."""
    n = sp.shape[0]
    qs = [sp[:, a] for a in range(3)]

    def d_at(s):
        cx = pp[s:s + n, 0]
        d = [cx - qs[0], pp[s:s + n, 1] - qs[1], pp[s:s + n, 2] - qs[2]]
        return cx, d, d[0] * d[0] + d[1] * d[1] + d[2] * d[2]

    span = 2 * w + 2
    c = span // 2
    rows = [j for d in range(span - c) for j in (c + d, c - 1 - d) if j >= 0]
    regs = [torch.full_like(qs[0], float("inf")) for _ in range(k)]
    for j in rows:
        if not 0 <= j - q <= 2 * w:
            continue
        v = d_at(j - q)[2]
        enter = v < regs[k - 1]
        new = [torch.minimum(regs[0], v)] + [
            torch.minimum(regs[r], torch.maximum(regs[r - 1], v))
            for r in range(1, k)]
        regs = [torch.where(enter, a, b) for a, b in zip(new, regs)]
    thr = regs[k - 1] * torch.tensor(wf._MARGIN, dtype=torch.float32)
    acc = [torch.zeros_like(qs[0]) for _ in range(11)]
    for s in range(2 * w + 1):
        cx, (dx, dy, dz), d2 = d_at(s)
        sel = (d2 <= thr) & (cx <= wf._FIN)
        terms = (torch.ones_like(d2), d2, dx, dy, dz, dx * dx, dy * dy,
                 dz * dz, dx * dy, dx * dz, dy * dz)
        acc = [torch.where(sel, a + t, a) for a, t in zip(acc, terms)]
    return (acc[0], acc[1], torch.stack(acc[2:5], dim=1),
            torch.stack(acc[5:11], dim=1))


@pytest.mark.parametrize("k,w", [(1, 4), (8, 2), (10, 8), (12, 16),
                                 (17, 8), (32, 16)])
@pytest.mark.parametrize("q", [0, 1])
def test_kernel_schedule_model_equals_plain_bitwise(rng, k, w, q):
    """The two identities the CUDA kernel's bit equality rests on: the k
    smallest distances (and so the threshold) do not depend on the order
    of the visits when a candidate at or above the k-th register is
    skipped; and skipping an unselected candidate's +0.0 term leaves every
    accumulator as it is (none is ever -0.0).  Bit for bit in f32, every
    output, on inputs with ties, duplicates, empty windows and products
    that underflow to -0.0."""
    sp, pp = _hard_inputs(rng, w)
    d = pp[w + 1:w + 301] - sp                   # the shift +1 offsets
    prod = d[:, 0] * d[:, 1]
    assert ((prod == 0) & np.signbit(prod)).any()     # -0.0 products occur
    sp_t, pp_t = torch.from_numpy(sp), torch.from_numpy(pp)
    got = _schedule_model(sp_t, pp_t, k, w, q)
    want = wf.window_fit_moments_plain(sp_t, pp_t, k, w)
    for g, p in zip(got, want):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))
    assert (want[0] == 0).any()                       # empty windows
    assert k >= 2 * w + 1 or (want[0] > k).any()      # ties admitted
