"""The port's certified exact normals scan against the JAX package's
``_normals_scan_exact``, against itself visiting every block, and through
``compute_normals(method="exact")``'s dispatch above the gather path's
size, on the same numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu.algorithms import normals as jnormals

from pasture_tpu_torch._device import fp32_matmul
from pasture_tpu_torch.algorithms import compute_normals, normals
from pasture_tpu_torch.buffers import HostPointBuffer, PointBatch
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.schema import PointSchema


@functools.lru_cache(maxsize=None)
def _jax_scan(k):
    """The JAX scan under one ``jax.jit``, pass 1 by ``top_k``: its own test
    holds those thresholds bit-identical to the default register merge."""
    return jax.jit(functools.partial(jnormals._normals_scan_exact, k=k,
                                     pass1_merge="topk"))


def _within(a, b, deg):
    """Share of unoriented normal pairs within ``deg`` degrees."""
    dot = np.abs(np.sum(a.astype(np.float64) * b, axis=1))
    return float((dot > np.cos(np.deg2rad(deg))).mean())


def _terrain(rng, n, size=80.0):
    """The reference test's surface (tests/test_algorithms.py:374-401)."""
    u = rng.uniform(-size, size, (n, 2))
    z = 0.3 * np.sin(u[:, 0] * 0.5) + 0.2 * np.cos(u[:, 1] * 0.8)
    return np.stack([u[:, 0], u[:, 1], z], axis=1).astype(np.float32)


def _scan(pos, valid, k, **kw):
    with fp32_matmul():
        return normals._exact_scan(torch.from_numpy(pos),
                                   torch.from_numpy(valid), k, **kw)


def test_scan_exact_matches_jax(rng):
    """16 384 points (two target blocks), 13 invalid rows, a 2 048-row query
    slice: the reference's tolerances (tests/test_algorithms.py:314-335)."""
    pos = _terrain(rng, 1 << 14)
    valid = np.arange(pos.shape[0]) < pos.shape[0] - 13
    q = pos[:2048]
    with fp32_matmul():
        got_n, got_c = [t.numpy() for t in normals._normals_scan_exact(
            torch.from_numpy(pos), torch.from_numpy(valid), 8,
            queries=torch.from_numpy(q))]
    want_n, want_c = [np.asarray(a) for a in _jax_scan(8)(
        jnp.asarray(pos), jnp.asarray(valid), queries=jnp.asarray(q))]
    assert got_n.shape == (2048, 3) and got_c.shape == (2048,)
    assert _within(got_n, want_n, 1.0) > 0.995
    np.testing.assert_allclose(got_c, want_c, atol=1e-3)


def _lattice():
    """A 20 x 20 x 20 integer lattice: exact f32 distances, and 19 targets
    at or within the 8th distance of an inner point (ties past 2k)."""
    g = np.arange(20, dtype=np.float32)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("scene,k", [("terrain", 8), ("terrain", 12),
                                     ("lattice", 8)])
def test_certified_equals_exhaustive_bit_for_bit(rng, scene, k):
    """The certified scan against the same code visiting every block in the
    same order: thresholds, normals and curvature equal to the bit, with
    blocks actually skipped (compact tiles of 512 queries over blocks of
    2048 targets); on the lattice, tiles whose ties sum whole blocks."""
    pos = _terrain(rng, 1 << 13) if scene == "terrain" else _lattice()
    valid = np.arange(pos.shape[0]) < pos.shape[0] - 13
    kw = dict(query_tile=512, chunk=2048)
    normals.SCAN_COUNTS.update(dict.fromkeys(normals.SCAN_COUNTS, 0))
    cert = _scan(pos, valid, k, **kw)
    dense = normals.SCAN_COUNTS["dense_tiles"]
    full = _scan(pos, valid, k, exhaustive=True, **kw)
    for a, b in zip(cert[1:4], full[1:4]):
        assert torch.equal(a, b)
    assert cert[4].sum() < full[4].sum() == cert[4].size * 4
    assert (dense > 0) == (scene == "lattice")
    # a subset of tiles gives those tiles' results
    sub = _scan(pos, valid, k, tiles=[0, 15, 7], **kw)
    for a, b in zip(sub[1:4], cert[1:4]):
        assert torch.equal(a, b[[0, 15, 7]])


def test_compute_normals_exact_dispatch(rng, monkeypatch):
    """``compute_normals(method="exact")`` above the cap, with the cap and
    the slice shrunk so the CPU runs the scan on three query slices, against
    the gather path on the same data (the reference's test,
    tests/test_algorithms.py:337-371)."""
    n = 12_000
    u = rng.uniform(-40, 40, (n, 2))
    z = 0.3 * np.sin(u[:, 0]) + 0.2 * np.cos(u[:, 1] * 1.3)
    pos = np.stack([u[:, 0], u[:, 1], z], axis=1).astype(np.float32)
    buf = HostPointBuffer(PointSchema.from_attributes([att.POSITION_3D]),
                          {att.POSITION_3D.name: pos.astype(np.float64)})
    ref_n, ref_c = compute_normals(buf, 10, method="exact", device="cpu")
    monkeypatch.setattr(normals, "_EXACT_NORMALS_MAX", 2048)
    monkeypatch.setattr(normals, "_EXACT_SLICE", 4096)
    calls = []
    scan = normals._normals_scan_exact
    monkeypatch.setattr(normals, "_normals_scan_exact",
                        lambda *a, **kw: calls.append(1) or scan(*a, **kw))
    got_n, got_c = compute_normals(buf, 10, method="exact", device="cpu")
    assert len(calls) == 3
    assert got_n.shape == (n, 3) and got_c.shape == (n,)
    assert _within(got_n, ref_n, 1.0) > 0.99
    np.testing.assert_allclose(got_c, ref_c, atol=1e-3)


def test_under_full_queries(rng):
    """Fewer valid targets than k: every query's threshold is inf, and the
    fit takes every valid target and no invalid row, as JAX's does."""
    pos = rng.uniform(0, 3, (40, 3)).astype(np.float32)
    pos[:, 2] = 0.5 * pos[:, 0] + 0.01 * pos[:, 2]
    valid = np.zeros(40, bool)
    valid[::6] = True                      # 7 valid targets, k = 8
    pos[~valid] += 100.0                   # far: they would pull the fit
    thr = _scan(pos, valid, 8, query_tile=16)[1]
    assert bool(torch.isinf(thr).all())
    with fp32_matmul():
        got_n, got_c = [t.numpy() for t in normals._normals_scan_exact(
            torch.from_numpy(pos), torch.from_numpy(valid), 8,
            query_tile=16)]
    want_n, want_c = [np.asarray(a) for a in jax.jit(functools.partial(
        jnormals._normals_scan_exact, k=8, query_tile=16,
        pass1_merge="topk"))(jnp.asarray(pos), jnp.asarray(valid))]
    assert np.isfinite(got_n).all() and np.isfinite(got_c).all()
    # every query fits the plane of the same seven points: within 0.1° of
    # its f64 fit from the queries among them, within 1° from the invalid
    # rows 100 m off (their query frame costs f32 digits)
    pts = pos[valid].astype(np.float64)
    plane = np.linalg.eigh(np.cov(pts.T))[1][:, 0]
    assert _within(got_n[valid], np.broadcast_to(plane, (7, 3)), 0.1) == 1.0
    assert _within(got_n, np.broadcast_to(plane, got_n.shape), 1.0) == 1.0
    assert _within(got_n, want_n, 1.0) == 1.0
    np.testing.assert_allclose(got_c, want_c, atol=1e-3)
    assert torch.equal(thr, _scan(pos, valid, 8, query_tile=16,
                                  exhaustive=True)[1])


def test_point_batch_padding_rows(rng, monkeypatch):
    """A ``PointBatch`` whose rows past ``count`` hold far-away points: the
    scan neither fits them nor takes them as neighbours, so its normals
    equal those of the count rows alone."""
    pos = _terrain(rng, 3000, size=10.0)
    pad = rng.uniform(50, 60, (1096, 3)).astype(np.float32)
    schema = PointSchema.from_attributes([att.POSITION_3D])
    batch = PointBatch({att.POSITION_3D.name: torch.from_numpy(
        np.concatenate([pos, pad]))}, torch.tensor(3000, dtype=torch.int32),
        schema, {})
    buf = HostPointBuffer(schema, {att.POSITION_3D.name: pos.astype(
        np.float64)})
    ref_n, ref_c = compute_normals(buf, 8, method="exact", device="cpu")
    monkeypatch.setattr(normals, "_EXACT_NORMALS_MAX", 1024)
    got_n, got_c = compute_normals(batch, 8, method="exact")
    assert got_n.shape == (3000, 3)
    assert _within(got_n, ref_n, 1.0) > 0.99
    np.testing.assert_allclose(got_c, ref_c, atol=1e-3)
