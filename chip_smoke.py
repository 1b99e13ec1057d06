#!/usr/bin/env python3
"""GPU smoke run of pasture_tpu_torch: the exact transform + voxelize step.

Run ``python3 chip_smoke.py`` on a machine with one NVIDIA Hopper GPU and
the CUDA toolkit.  It

1. names the device (``device``),
2. builds the package's CUDA kernels from ``ops/kernels/csrc`` (``build``),
3. holds each kernel against its plain PyTorch version on the GPU at the
   shapes of the main path — 4 194 304 points in 8192 tiles of 512 rows —
   and times kernel, plain version and, where one exists, the single
   PyTorch call that computes the same function (``kernels``),
4. drives the main path once through the package's public functions —
   i32 LAS local coordinates -> world bounds -> Morton key + exact 10-bit
   residual word -> tile sort -> per-voxel mean / mode / centroid, one
   compacted voxel batch — checks it against the package's generic
   plain-PyTorch path and an f64 numpy oracle, reads the kernels' launch
   counts, and times the step (``main_path``).

``--profile`` adds a ``profile`` line: one step's GPU time by kernel name.

Each phase prints one JSON line.  Nothing is caught: any failure raises and
the process exits non-zero.  Without a CUDA device it raises at once; it
never carries on on the CPU.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from pasture_tpu_torch._device import resolve_device
from pasture_tpu_torch.buffers.device import PointBatch
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.ops import u32_bits, u32_carrier, voxel_downsample
from pasture_tpu_torch.ops import kernels
from pasture_tpu_torch.ops.kernels import _build
from pasture_tpu_torch.ops.kernels import fused_transform as ft
from pasture_tpu_torch.ops.kernels import tile_sort_kernel as ts
from pasture_tpu_torch.ops.kernels import voxel_reduce_kernel as vr

N = 1 << 22          # points of the headline step
LEAF = 0.5
ZTILES = 1024        # z-slabs, one leaf thick (the 10-bit grid's z capacity)
XTILES = 8           # world-x stripes per slab, voxel-aligned
LOCAL = "LASLocalPosition"

_THETA = 0.25
ROT = np.asarray([[np.cos(_THETA), -np.sin(_THETA), 0.0],
                  [np.sin(_THETA), np.cos(_THETA), 0.0],
                  [0.0, 0.0, 1.0]], np.float32)
TRANS = np.asarray([10.0, -5.0, 2.0], np.float64)
SCALE = np.asarray([0.001, 0.001, 0.001], np.float32)

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate
# and the float32 rate outside the tensor cores, which is also what the
# 32-bit integer and compare operations of these kernels are held against.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


# ---- data ------------------------------------------------------------------

def make_columns(n: int, ztiles: int = ZTILES, xtiles: int = XTILES,
                 seed: int = 7):
    """Random points arranged as ``ztiles * xtiles`` spatially disjoint
    (z-slab, world-x-stripe) tiles — the shape in which tiled ingest hands
    batches to the voxelizer.  Tile boundaries are voxel multiples in the
    output frame (the transform rotates about z), so per-tile voxelization
    equals global voxelization.  Returns numpy ``(local i32 (n, 3),
    intensity u16, classification u8)``."""
    rng = np.random.default_rng(seed)
    per = n // (ztiles * xtiles)
    wx_lo, wx_hi = 60.0, 140.0    # inner box of the rotated local region
    stripe = (wx_hi - wx_lo) / xtiles
    if (stripe / LEAF) != round(stripe / LEAF):
        raise ValueError("x stripes must be whole voxels wide")
    parts = []
    for zi in range(ztiles):
        for xi in range(xtiles):
            wx = rng.uniform(wx_lo + xi * stripe,
                             wx_lo + (xi + 1) * stripe, per)
            wy = rng.uniform(-40.0, 40.0, per)
            wz = TRANS[2] + (zi * 500 + rng.uniform(0, 500, per)) * 0.001
            w = np.stack([wx, wy, wz], axis=1)
            loc = ((w - TRANS) @ ROT.astype(np.float64)) / 0.001
            parts.append(np.round(loc).astype(np.int32))
    local = np.concatenate(parts)
    intensity = rng.integers(0, 65536, size=n, dtype=np.uint16)
    cls = rng.integers(0, 32, size=n, dtype=np.uint8)
    return local, intensity, cls


def make_batch(local, intensity, cls, device=None) -> PointBatch:
    """The step's input batch (``device=None``: the GPU)."""
    schema = PointSchema.from_attributes(
        [att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION])
    return PointBatch.from_columns(schema, {
        LOCAL: torch.from_numpy(np.ascontiguousarray(local)),
        att.INTENSITY.name: torch.from_numpy(intensity.astype(np.int32)),
        att.CLASSIFICATION.name: torch.from_numpy(cls),
    }, device=device)


# ---- the main path -----------------------------------------------------------

def affine_on(device):
    """The step's rigid transform as tensors on ``device`` (made once:
    ``(scale, rot, trans)``)."""
    return (torch.from_numpy(SCALE).to(device),
            torch.from_numpy(ROT).to(device),
            torch.tensor([10.0, -5.0, 2.0], dtype=torch.float32,
                         device=device))


def pipeline_head(batch: PointBatch, affine, shift: float = 0.0):
    """Bounds, grid anchor, base coefficients, keys and residual words of
    one step.  Returns ``(bmin, keys, rword, local_affine)``."""
    local = batch.data[LOCAL]
    scale, rot, t = affine
    t = t + shift
    wmin, _ = kernels.fused_world_bounds(local, scale, rot, t)
    # grid anchored at leaf multiples in x (stripe boundaries stay
    # voxel-aligned) and at the z-translation (z-slab boundaries ditto);
    # the y anchor is data-driven
    bmin = torch.stack([torch.floor(wmin[0] / LEAF) * LEAF, wmin[1], t[2]])
    # the host copy of the scale serves the leaf-size check without
    # reading the device
    coeffs = kernels.exact_local_base_coeffs(SCALE, rot, t, bmin, LEAF,
                                             "floor")
    keys, rword = kernels.fused_voxel_head_exact_local(
        local, scale, rot, t, bmin, LEAF, coeffs, semantics="floor")
    return bmin, keys, rword, (scale, rot, t, coeffs)


def pipeline_voxelize(batch: PointBatch, head, tiles: int,
                      fused: bool = True) -> PointBatch:
    """Voxelize the batch's attributes under the head's keys;
    ``fused=False`` is the package's generic plain-PyTorch path."""
    bmin, keys, rword, affine = head
    data = {k: v for k, v in batch.data.items() if k != LOCAL}
    b = PointBatch(data, batch.count, batch.schema, batch.meta, batch.policy)
    return voxel_downsample(b, LEAF, bounds=(bmin, None), semantics="floor",
                            grid_bits=10, sort_tiles=tiles,
                            precomputed=(keys, rword), local_affine=affine,
                            fused=fused)


def pipeline_batch(batch: PointBatch, affine, tiles: int,
                   shift: float = 0.0) -> PointBatch:
    """One exact transform + voxelize step, returning the voxel batch."""
    return pipeline_voxelize(batch, pipeline_head(batch, affine, shift),
                             tiles)


# ---- timing ------------------------------------------------------------------

_SPIN_CYCLES = 20_000_000   # ~10 ms of GPU idle spin: the host runs ahead


def gpu_ms(fn, flush: torch.Tensor, warmup: int = 2, reps: int = 10
           ) -> float:
    """Median GPU time of ``fn()`` in ms (CUDA events).  Before each timed
    call the GPU spins while the host enqueues the call, so host-side launch
    gaps are not in the time, and a buffer larger than the L2 cache is
    overwritten, so the call finds its inputs in device memory."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(_SPIN_CYCLES)
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def bound(n_bytes: float, n_ops: float):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and operations over the float32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# ---- phases ------------------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(info), flush=True)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps({"phase": "build", "sources": sorted(_build.SOURCES),
                      "seconds": time.perf_counter() - t0}), flush=True)


def _pack_word(batch: PointBatch) -> torch.Tensor:
    """The packed word of the main path: Classification (u8, mode) in the
    top 8 bits, Intensity (u16, mean) below it."""
    return ((batch.data[att.CLASSIFICATION.name].to(torch.int64) << 24)
            | (batch.data[att.INTENSITY.name].to(torch.int64) << 8))


_FIELDS = ((8, 16, False, 0, 65535),)   # Intensity in the packed word
_MODE_BITS = 8                          # Classification


def phase_kernels(batch: PointBatch, affine, tiles: int) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    dev = batch.device
    scale, rot, t = affine
    local = batch.data[LOCAL]
    n = local.shape[0]
    tile_len = n // tiles
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def row(name, source, replaces, err, ms, plain_ms, n_bytes, n_ops,
            library_ms=None):
        b_ms, by = bound(n_bytes, n_ops)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": float(err), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": library_ms})

    # K1: bit-exact (the same individually rounded f32 operations; min and
    # max do not depend on order)
    got = torch.cat(kernels.fused_world_bounds(local, scale, rot, t))
    want = torch.cat(ft.fused_world_bounds_plain(local, scale, rot, t))
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"fused_world_bounds: {got} != plain {want}")
    row("fused_world_bounds",
        "pasture_tpu_torch/ops/kernels/csrc/world_bounds.cu",
        "pasture_tpu/ops/kernels/fused_transform.py:171",
        (got - want).abs().max().item(),
        gpu_ms(lambda: kernels.fused_world_bounds(local, scale, rot, t),
               flush),
        gpu_ms(lambda: ft.fused_world_bounds_plain(local, scale, rot, t),
               flush, reps=5),
        # 12 B read per point; 3 converts, 12 multiplies, 9 adds, 6 min/max
        12.0 * n + 24, 30.0 * n)

    # K2: bit-exact keys and residual words
    bmin, keys, rword, local_affine = pipeline_head(batch, affine)
    coeffs = local_affine[3]
    args = (local, scale, rot, t, bmin, LEAF, coeffs, "floor")
    pkeys, prword = ft.fused_voxel_head_exact_local_plain(*args)
    torch.cuda.synchronize()
    dk = (u32_carrier(keys) - pkeys).abs().max().item()
    dr = (u32_carrier(rword) - prword).abs().max().item()
    if dk or dr:
        raise AssertionError(f"fused_voxel_head_exact_local differs from "
                             f"its plain version: key {dk}, rword {dr}")
    row("fused_voxel_head_exact_local",
        "pasture_tpu_torch/ops/kernels/csrc/voxel_head.cu",
        "pasture_tpu/ops/kernels/fused_transform.py:396", max(dk, dr),
        gpu_ms(lambda: kernels.fused_voxel_head_exact_local(*args), flush),
        gpu_ms(lambda: ft.fused_voxel_head_exact_local_plain(*args), flush,
               reps=5),
        # 12 B read + 8 B written per point; transform 24, cells 18,
        # Morton spread 41, integer bases 27, residuals and packing 13
        20.0 * n, 123.0 * n)

    # K4: key streams bit-exact; per tile the multiset of rows equal (the
    # sort is unstable: rows with equal (key, word) may come in any order)
    word = _pack_word(batch)
    streams = [u32_bits(keys), u32_bits(word), u32_bits(rword)]
    got = kernels.tile_sort(streams, tile_len, num_keys=2)
    want = ts.tile_sort_plain(streams, tile_len, num_keys=2)
    torch.cuda.synchronize()
    gotc = [u32_carrier(s) for s in got]
    dkey = max((gotc[i] - want[i]).abs().max().item() for i in range(2))
    if dkey:
        raise AssertionError(f"tile_sort: key streams differ by {dkey}")
    full_g = ts.lex_order(gotc, tile_len)
    full_w = ts.lex_order(list(want), tile_len)
    for g, w in zip(gotc, want):
        if not torch.equal(g[full_g], w[full_w]):
            raise AssertionError("tile_sort: a tile's rows are not a "
                                 "permutation of its input rows")
    packed = ((u32_carrier(keys) << 32) | word).reshape(tiles, tile_len)
    resid = u32_bits(rword).reshape(tiles, tile_len)

    def library_sort():
        s = torch.sort(packed, dim=1)
        return s.values, resid.gather(1, s.indices)

    stages = (tile_len.bit_length() - 1) * tile_len.bit_length() // 2
    row("tile_sort", "pasture_tpu_torch/ops/kernels/csrc/tile_sort.cu",
        "pasture_tpu/ops/kernels/tile_sort_kernel.py:132", dkey,
        gpu_ms(lambda: kernels.tile_sort(streams, tile_len, num_keys=2),
               flush),
        gpu_ms(lambda: ts.tile_sort_plain(streams, tile_len, num_keys=2),
               flush, reps=5),
        # 12 B read + 12 B written per row; per compare-exchange 4 compares
        # of the two key words and 6 moves of the three streams
        24.0 * n, 10.0 * stages * (n // 2),
        library_ms=gpu_ms(library_sort, flush, reps=5))

    # K3: count and out_word exact; centroids atol 1e-5 — the same f32
    # operations on exact integer sums, so the kernel is expected to agree
    # bit for bit and the tolerance only allows for a differently rounded
    # division
    rargs = (got[0], got[1], got[2], bmin, LEAF, _MODE_BITS, _FIELDS, 10,
             1.0, tile_len, "floor")
    kpos, kword, kcount = vr.fused_sorted_voxel_reduce_rows(
        *rargs, local_affine=local_affine)
    ppos, pword, pcount = vr.fused_sorted_voxel_reduce_plain(
        *rargs, local_affine=local_affine)
    torch.cuda.synchronize()
    nv = int(kcount.item())
    if nv != int(pcount.item()):
        raise AssertionError(f"fused_sorted_voxel_reduce: {nv} voxels, "
                             f"plain {int(pcount.item())}")
    if not torch.equal(u32_carrier(kword), pword):
        raise AssertionError("fused_sorted_voxel_reduce: out_word differs")
    err = (kpos - ppos).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"fused_sorted_voxel_reduce: centroids differ "
                             f"by {err}")
    row("fused_sorted_voxel_reduce",
        "pasture_tpu_torch/ops/kernels/csrc/voxel_reduce.cu",
        "pasture_tpu/ops/kernels/voxel_reduce_kernel.py:415", err,
        gpu_ms(lambda: vr.fused_sorted_voxel_reduce_rows(
            *rargs, local_affine=local_affine), flush),
        gpu_ms(lambda: vr.fused_sorted_voxel_reduce_plain(
            *rargs, local_affine=local_affine), flush, reps=5),
        # 12 B read per row, 16 B written per voxel of this run, 4 B per
        # tile count; ~24 integer operations per row, ~80 per voxel
        12.0 * n + 16.0 * nv + 4.0 * tiles, 24.0 * n + 80.0 * nv)
    return rows


def f64_oracle(local: np.ndarray, keys: np.ndarray, tile_len: int
               ) -> np.ndarray:
    """Centroid of every (tile, voxel) group in f64: the affine image of
    the exact mean of the i32 locals, in (tile, Morton key) order."""
    n = keys.shape[0]
    group = (np.arange(n, dtype=np.int64) // tile_len) << 32 \
        | keys.astype(np.int64)
    _, inverse, counts = np.unique(group, return_inverse=True,
                                   return_counts=True)
    mean = np.stack([np.bincount(inverse, weights=local[:, a].astype(
        np.float64)) for a in range(3)], axis=1) / counts[:, None]
    return (mean * SCALE.astype(np.float64)) @ ROT.astype(np.float64).T \
        + TRANS


def phase_main_path(batch: PointBatch, affine, local_np: np.ndarray,
                    tiles: int, rows: list, smi: str) -> None:
    n = batch.capacity
    pos, inten, cls = (att.POSITION_3D.name, att.INTENSITY.name,
                       att.CLASSIFICATION.name)
    kernels.reset_launch_counts()
    head = pipeline_head(batch, affine)
    out = pipeline_voxelize(batch, head, tiles)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for r in rows:
        r["launches"] = counts[r["name"]]
        if r["launches"] < 1:                                   # check (c)
            raise AssertionError(f"the main path never launched {r['name']}")

    nv = int(out.count.item())
    got_pos = out.data[pos][:nv]
    if not bool(torch.isfinite(got_pos).all()) or nv == 0:
        raise AssertionError("main path: no voxels or non-finite centroids")

    # (a) the package's generic exact-local path, plain PyTorch on the GPU
    ref = pipeline_voxelize(batch, head, tiles, fused=False)
    if int(ref.count.item()) != nv:
        raise AssertionError(f"main path: {nv} voxels, generic path "
                             f"{int(ref.count.item())}")
    for name in (inten, cls):
        if not torch.equal(out.data[name][:nv], ref.data[name][:nv]):
            raise AssertionError(f"main path: column {name} differs from "
                                 f"the generic path")
    err_generic = (got_pos - ref.data[pos][:nv]).abs().max().item()
    if not err_generic <= 1e-4:
        raise AssertionError(f"main path: centroids differ from the generic "
                             f"path by {err_generic}")
    if bool((out.data[pos][nv:] != 0).any()):
        raise AssertionError("main path: rows past count are not zero")
    del ref

    # (d) the generic path's tiled sort on the GPU: a float max column
    # keeps the call off the fused reduce, so voxel_downsample sorts (key,
    # word, f32 column, residual) with the tile_sort kernel and reduces in
    # plain PyTorch; it must equal the same call without any kernel
    sub_tiles = min(tiles, 128)
    m = sub_tiles * (n // tiles)
    bmin, keys, rword, local_affine = head
    gps = torch.arange(m, dtype=torch.float32, device=batch.device) % 977
    sub = PointBatch({inten: batch.data[inten][:m], cls: batch.data[cls][:m],
                      att.GPS_TIME.name: gps}, batch.count - (n - m + 5),
                     PointSchema.from_attributes(
                         [att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION,
                          att.GPS_TIME]))
    outs = [voxel_downsample(sub, LEAF, bounds=(bmin, None),
                             semantics="floor", grid_bits=10,
                             sort_tiles=sub_tiles,
                             precomputed=(keys[:m], rword[:m]),
                             local_affine=local_affine, fused=f)
            for f in (True, False)]
    sorts = kernels.launch_counts()["tile_sort"] - counts["tile_sort"]
    if sorts != 1:
        raise AssertionError(f"generic path on the GPU: {sorts} tile_sort "
                             f"launches, expected 1")
    for name in outs[0].data:
        if not torch.equal(outs[0].data[name], outs[1].data[name]):
            raise AssertionError(f"generic path on the GPU: column {name} "
                                 f"differs with and without tile_sort")

    # (b) f64 numpy oracle over every tile
    oracle = f64_oracle(local_np, u32_carrier(head[1]).cpu().numpy(),
                        n // tiles)
    if oracle.shape[0] != nv:
        raise AssertionError(f"main path: {nv} voxels, oracle "
                             f"{oracle.shape[0]}")
    err_oracle = float(np.linalg.norm(
        got_pos.cpu().numpy().astype(np.float64) - oracle, axis=1).max())
    if not err_oracle < 5e-4:
        raise AssertionError(f"main path: a centroid is {err_oracle} from "
                             f"the f64 oracle")

    # the whole step as a caller sees it: events around each step, host
    # launch gaps included
    times = []
    for i in range(13):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        pipeline_batch(batch, affine, tiles, shift=(i % 7) * 1e-6)
        e1.record()
        e1.synchronize()
        if i >= 3:
            times.append(e0.elapsed_time(e1))
    step_ms = float(np.median(times))
    print(json.dumps({
        "phase": "main_path", "points": n, "tiles": tiles, "voxels": nv,
        "launches": counts, "max_err_vs_generic_path": err_generic,
        "max_err_vs_f64_oracle": err_oracle, "oracle_tiles": tiles,
        "step_ms": step_ms, "step_ms_min": float(min(times)),
        "step_ms_max": float(max(times)), "repeats": len(times),
        "mpoints_per_s": n / step_ms / 1e3, "card": smi}), flush=True)


def phase_profile(batch: PointBatch, affine, tiles: int) -> None:
    """Where one step's GPU time goes: device time by kernel name over five
    steady steps (``torch.profiler``), the hand kernels marked."""
    from torch.profiler import ProfilerActivity, profile
    steps = 5
    pipeline_batch(batch, affine, tiles)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            pipeline_batch(batch, affine, tiles, shift=(i % 7) * 1e-6)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ours = ("world_bounds", "voxel_head", "tile_sort", "voxel_reduce")
    by_name = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name.setdefault(e.name, [0.0, 0])
            by_name[e.name][0] += e.device_time / 1e3 / steps
            by_name[e.name][1] += 1
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]
    print(json.dumps({
        "phase": "profile", "steps": steps, "traced_wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy,
        "hand_kernels_ms_per_step": sum(
            v[0] for k, v in by_name.items() if any(o in k for o in ours)),
        "device_launches_per_step": sum(
            v[1] for v in by_name.values()) / steps,
        "top": [{"name": k[:60], "ms_per_step": v[0],
                 "calls_per_step": v[1] / steps} for k, v in top]}),
        flush=True)


def main() -> int:
    dev = resolve_device(None)          # raises without a CUDA device
    info = phase_device()
    phase_build()
    tiles = ZTILES * XTILES
    local_np, inten_np, cls_np = make_columns(N)
    batch = make_batch(local_np, inten_np, cls_np, device=dev)
    affine = affine_on(dev)
    rows = phase_kernels(batch, affine, tiles)
    print(json.dumps({"phase": "kernels", "points": N, "tiles": tiles,
                      "names": [r["name"] for r in rows]}), flush=True)
    phase_main_path(batch, affine, local_np, tiles, rows,
                    info["nvidia_smi"])
    if "--profile" in sys.argv[1:]:
        phase_profile(batch, affine, tiles)
    print(json.dumps({"kernels": rows}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
