#!/usr/bin/env python3
"""GPU smoke run of pasture_tpu_torch: the transform + voxelize steps, the
filter -> voxel grid path, normals, registration, the file -> map fold,
the other formats, RANSAC, the convex hull and reprojection.

Run ``python3 chip_smoke.py`` on a machine with one NVIDIA Hopper GPU and
the CUDA toolkit.  It

1. names the device (``device``),
2. builds the package's CUDA kernels from ``ops/kernels/csrc`` and, beside
   them, the LASzip codec from ``native/src`` (``build``; a codec that does
   not build fails the run),
   then holds the tile sort against its plain version over every tile
   length, stream count and key count it has a code path for, on
   adversarial tiles (``tile_sort_sweep``), and K6 against its plain
   version bit for bit over k and window sizes on inputs with ties,
   duplicates, empty windows and underflowing products
   (``window_fit_sweep``), K3 in its three forms over tile lengths 1 to
   4096, word layouts and adversarial tiles (``voxel_reduce_sweep``), K5
   over row counts, masks and row widths, nine columns a call, and rows
   wider than one launch takes (``compact_sweep``), and K1 bit for bit over
   point counts 1 to 4 194 305, base views 1-3 rows off a 16-byte
   boundary, the extreme point first, last and in the scalar tail, repeated
   calls, two streams, host and device parameters (``world_bounds_sweep``),
3. holds each kernel against its plain PyTorch version on the GPU at the
   shapes of the paths below — 4 194 304 points in 8192 tiles of 512 rows —
   and times kernel, plain version and, where one exists, the single
   PyTorch call that computes the same function (``kernels``),
4. drives the main path once through the package's public functions —
   i32 LAS local coordinates -> world bounds -> Morton key + exact 10-bit
   residual word -> tile sort -> per-voxel mean / mode / centroid, one
   compacted voxel batch — checks it against the package's generic
   plain-PyTorch path and an f64 numpy oracle, reads the kernels' launch
   counts, and times the step (``main_path``),
5. drives three more paths the same way, each at the same 4 194 304 points,
   each checked before it is timed, each with the launch counts set to 0
   just before and read just after:
   ``path_filter_grid`` — ``filter_batch`` (compaction kernel) ->
   ``voxelgrid_filter`` (generic voxel path, 20-bit grid) ->
   ``calculate_bounds`` / ``minmax_attribute``;
   ``path_quantized`` — ``fused_voxel_head`` -> ``voxel_downsample(
   precomputed=(keys, qword), position_quantization_bits=10)``, and the same
   call without ``precomputed`` on a batch of f32 world positions;
   ``path_exact_f32`` — ``fused_world_bounds`` ->
   ``fused_decode_transform_key`` -> ``voxel_downsample(precomputed=(keys,
   None))`` with the f32 positions riding a five-stream tile sort;
6. drives normals and registration, each gated before it is timed:
   ``path_normals`` — ``compute_normals(method="morton")`` on a 2 097 152-
   point surface from a host buffer (K6 twice), against the analytic
   surface normal and against the same call on K6's plain version;
   ``path_icp`` — Morton-correspondence ICP at 1 048 576 points, point-to-
   point and point-to-plane (K6 for the target normals), against the known
   pose, and the point-to-plane pose against the same run on K6's plain
   version; ``path_registration`` — ``RegistrationPipeline`` over four
   scans (the generic voxel path on K5, exact point-to-plane ICP) against
   the known trajectory, K5 against its plain version on one scan's own
   inputs, then the pose graph (dense and CG) bringing knocked keyframes
   back to their odometry poses; ``path_normals_exact`` — the port of
   ``benches/normals_bench.py --exact``: ``compute_normals(method=
   "exact")`` of the bench's surface at 1 048 576 points (k = 12, the
   certified scan), more than 0.99 of the bench's kd-tree subsample within
   1° of a host ``cKDTree`` oracle, the certified scan equal to the same
   code visiting every block on 8 query tiles bit for bit, the card
   against the CPU at 65 537 points; seconds, block visits, host syncs,
   peak memory, busy share; ``path_pose_graph`` — the port of
   ``benches/pose_graph_bench.py``: its circle graph solved dense at 256,
   1 024 and 2 048 poses and by CG at 1 024 to 20 000, costs falling, ATE
   below the start, dense = CG at 1 024 within 1e-6 m; ms per Gauss-Newton
   iteration; ``path_trajectory`` — ``RegistrationPipeline`` over a closed
   loop of ``TRAJ_SCANS`` fresh 1 048 576-point scans of a 64 m tile with
   walls across x and y, each in its own frame, the loop closed by ICP,
   ``optimize(10)``: keyframe poses against the truth (mean 0.02 m, worst
   0.05 m, 0.2°), the map's voxel count within 2 % of the true poses' map,
   K5 held against its plain version on a scan's inputs; wall seconds, the
   split per scan, busy share;
7. drives the merge of tiles before a voxel step (``path_concat_convert``):
   ``PointBatch.concatenate`` of eight padded batches (K5 once), then
   ``convert_batch_schema`` and an LAS encode of the decoded positions that
   must give the locals back, against the same calls on the CPU.
8. drives the file -> map path (``path_file_to_map``), the port of
   ``benches/end_to_end_bench.py``: the bench's Morton-ordered survey (200
   points a square metre) written by the package's ``LasWriter`` as a LAS
   file of 16 777 216 points and, with the same points beside it as LAS, a
   LAZ file of 4 194 304, each folded by ``streaming_voxel_downsample`` in
   chunks of 2**20 points (512-row tile sorts on K4, compactions on K5,
   the two-stage merge on the card).  Gate before any time counts: the
   LAS fold with run tables equals a one-shot voxelization of the whole
   file (count, cell keys, point counts, Classification; Intensity within
   1; centroids within 1e-4 m + 1e-6) and an f64 oracle within 5e-4 m;
   the LAZ fold equals the LAS fold of its points bit for bit.  Then host
   read, upload, the fold's time (median of 2), device busy, K4 / K5
   launches a chunk and the fold's host syncs; K4 and K5 are held against
   their plain versions on the inputs the fold gave them.
9. drives the rest of the single-card surface, each phase gated before it
   is timed:
   ``path_formats`` — the survey with colours and normals written as
   ``.pnts`` with ``rtc_center``, with quantized positions and with oct16p
   normals, and 262 144 of its points as ASCII; each read back by the
   package's readers and onto the card by ``read_batch`` and held to what
   was written; ``convert`` (ASCII -> LAS -> ``.pnts``) and ``info
   --detailed`` against numpy's min/max; then the ``.pnts`` fold gated as
   the LAS fold is, K4 and K5 counted and held against their plain
   versions on its inputs; write, read and fold rates;
   ``path_segmentation`` — ``ransac_plane_device`` (4 194 304 points, 1024
   hypotheses) and ``ransac_line_device`` (1 048 576, 256): every
   hypothesis's count and the winner's inliers against an f64 recount of
   the same inputs on the card, but for points within the f32 rounding
   bound of the threshold; 90 % of the scene's own points; a second call
   equal; the card against the CPU at 65 536 points; call time, device
   busy and peak memory;
   ``path_hull`` — both hull calls at 1 000, 10 000 and 100 000 points
   (the largest a batch on the card) against qhull's vertices, the inside
   oracle and Euler's formula; seconds;
   ``path_reproject`` — a UTM 32N tile of 4 194 304 points (an f64 batch
   on the card) to WGS 84 and back with the builtin engine: the golden
   cases, the round trip within 10 µm, the column still on the card, and
   ``libproj`` within 1e-4 m where it loads; rates and the copies' share.
10. drives the distributed layer (``path_distributed``): every entry point
   of ``pasture_tpu_torch.parallel`` and ``RegistrationPipeline(mesh=)`` in
   two worlds — (a) one NCCL rank in this process, (b) ``DIST_SIZE`` ranks
   spawned on the same card with gloo, each collective staged through host
   memory and counted, the ranks loading the kernels this process built —
   at the single-card paths' sizes: bounds, the quantized voxelize a shard
   (path B (ii), K4 and K3'q once a shard), the merged voxelize with run
   tables (K5), the Morton partition and halo exchange, halo-windowed
   normals (K6), replicated and partitioned ICP, the dense and CG pose
   graph, ``sharded_read_all`` of four LAS files and the pipeline over the
   trajectory's first scans.  Each step is gated against the single-device
   path (``gate_distributed``), world (b) against world (a)
   (``compare_worlds``), and in world (b) the card's partition against the
   same ranks' partition on the CPU bit for bit; then seconds per step,
   collective and staged bytes, K3–K6 launches a step and rank 0's device
   busy.  K4, K3'q, K5 and K6 are held against their plain versions on the
   inputs world (a) gave them and timed as rows.  World (b) then lays its
   four ranks out as a ``("hosts", "points")`` mesh of shape (2, 2) and runs
   the main path's steps over ``"points"`` (shard, bounds, the quantized
   and the merged voxelize, partition and halo, normals, partitioned
   point-to-plane ICP, CG pose graph), gated by ``gate_mesh2d``: the two
   ``hosts`` rows bit-equal (the pose graph, whose sums are float atomics on
   the card, within 1e-9 m), each step against the single-device path; K3'q
   and K5 are held against their plain versions on rank 0's inputs there.

The ``kernels`` phase also holds K6 against its plain version at the
normals path's shape and at the point-to-plane ICP's, and K8 (the fused
exact ICP iteration) at the odometry benchmark's keyframe shape (2 400 x
2 400) and at 1 048 576 x 1 048 576, every bit of K8a's partials and of
K8b's pose equal.  ``--profile`` adds
a ``call_split`` line (the device operations of one K1, one K3 and one K5
call) and a ``profile`` line per path (``path_segmentation``'s plane
included): one step's GPU time by kernel name.

Each phase prints one JSON line.  Nothing is caught: any failure raises and
the process exits non-zero.  Without a CUDA device it raises at once; it
never carries on on the CPU.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import importlib.util
import io
import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pasture_tpu_torch import algorithms, parallel
from pasture_tpu_torch._device import fp32_matmul, resolve_device
from pasture_tpu_torch.algorithms import convexhull as hull_mod
from pasture_tpu_torch.algorithms import reprojection as reproj_mod
from pasture_tpu_torch.algorithms import segmentation as seg
from pasture_tpu_torch.algorithms import normals as normals_mod
from pasture_tpu_torch.buffers.device import PointBatch
from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.io import (AsciiReader, AsciiWriter, PntsReader,
                                  PntsWriter, open_reader, read_all,
                                  read_batch, write_all)
from pasture_tpu_torch.io import streaming
from pasture_tpu_torch.io.tiles3d.pnts import oct16p_decode, oct16p_encode
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout import dtypes as dt
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.math.morton import morton_encode_u64
from pasture_tpu_torch.ops import (convert_batch_schema, decode_las_positions,
                                   encode_las_positions, filter_batch,
                                   u32_bits, u32_carrier, voxel_downsample,
                                   voxel_indices)
from pasture_tpu_torch.ops import kernels
from pasture_tpu_torch.ops.kernels import _build
from pasture_tpu_torch.ops.kernels import compact_kernel as ck
from pasture_tpu_torch.ops.kernels import icp_step_kernel as ist
from pasture_tpu_torch.ops.kernels import fused_transform as ft
from pasture_tpu_torch.ops.kernels import tile_sort_kernel as ts
from pasture_tpu_torch.ops.kernels import voxel_reduce_kernel as vr
from pasture_tpu_torch.ops.kernels import window_fit_kernel as wf
from pasture_tpu_torch.native import laszip
from pasture_tpu_torch.native import proj as native_proj
from pasture_tpu_torch.ops.compact import compact_columns
from pasture_tpu_torch.parallel import spawn as par_spawn
from pasture_tpu_torch.pipeline import RegistrationPipeline
from pasture_tpu_torch.registration import (PoseGraph, icp,
                                            optimize_pose_graph, so3_exp)
from pasture_tpu_torch.registration.pose_graph import edge_residuals
from pasture_tpu_torch.tools import convert as convert_tool
from pasture_tpu_torch.tools import info as info_tool

# the modules (the package's ``voxel_downsample`` and
# ``merge_voxel_batches`` are the functions)
voxel_mod = importlib.import_module("pasture_tpu_torch.ops.voxel")
merge_mod = importlib.import_module("pasture_tpu_torch.ops.voxel_merge")

N = 1 << 22          # points of the headline step
LEAF = 0.5
ZTILES = 1024        # z-slabs, one leaf thick (the 10-bit grid's z capacity)
XTILES = 8           # world-x stripes per slab, voxel-aligned
LOCAL = "LASLocalPosition"
POS, INT, CLS = (att.POSITION_3D.name, att.INTENSITY.name,
                 att.CLASSIFICATION.name)
QBITS = 10           # residual bits per axis of the quantized path

_THETA = 0.25
ROT = np.asarray([[np.cos(_THETA), -np.sin(_THETA), 0.0],
                  [np.sin(_THETA), np.cos(_THETA), 0.0],
                  [0.0, 0.0, 1.0]], np.float32)
TRANS = np.asarray([10.0, -5.0, 2.0], np.float64)
SCALE = np.asarray([0.001, 0.001, 0.001], np.float32)

# normals (benches/normals_bench.py): surface points, k, Morton window
NORMALS_N = 1 << 21
NORMALS_K = 12
NORMALS_WINDOW = 64
# ICP (benches/icp_bench.py): points, iterations, the true misalignment
ICP_N = 1 << 20
ICP_ITERS = 30
ICP_THETA = np.deg2rad(1.0)
ICP_SHIFT = np.asarray([0.21, -0.13, 0.08], np.float32)
ICP_MAX_DIST = 4.0
ICP_NORMALS_K = 10   # the target normals of point-to-plane ICP (icp.py)
# K8's rows: the odometry cell's keyframes (~2.4 k points a 1 m voxel map of
# an HDL-64E scan) and a million-point pair; operations a pair of K8a, as the
# float32 rate counts them: built with -fmad=false, its 3 differences, 3
# squares and 2 sums are 8 separate instructions, each in a slot the rate
# credits with an FMA's 2 operations (the compare and select issue on
# another pipe and are not counted)
ICP_STEP_SHAPES = (("", 2400), ("_1m", 1 << 20))
ICP_STEP_PAIR_OPS = 16.0
# registration pipeline: scans of one scene, their spacing along x, voxel
REG_SCANS = 4
REG_N = 1 << 16
REG_STEP = 0.1
REG_VOXEL = 0.25
# the knock every keyframe but the first gets before the pose graph: a turn
# about a random axis (rad) and a shift of random direction (m)
REG_KNOCK_ROT = np.deg2rad(2.0)
REG_KNOCK_T = 0.05
# merging tiles before a voxel step: padded batches, their capacity, the
# LAS locals' attribute and their scale and (UTM-like) offset
CONCAT_BATCHES = 8
CONCAT_CAPACITY = 1 << 19
LAS_LOCAL = att.PointAttribute(LOCAL, dt.VEC3I32)
LAS_SCALE = np.asarray([0.001, 0.001, 0.001])
LAS_OFFSET = np.asarray([500000.0, 4000000.0, 0.0])
#: the merged batch's target schema: f32 intensity, and GpsTime, which no
#: input has (zero-filled)
CONVERT_SCHEMA = PointSchema.from_attributes(
    [LAS_LOCAL, att.INTENSITY.with_dtype(dt.F32), att.CLASSIFICATION,
     att.GPS_TIME])

# the file -> map path: the survey of benches/end_to_end_bench.py (200
# points a square metre, Morton-ordered), folded in chunks of 2**20 points
# sorted in 512-row tiles; the bench's 2**25 points are halved for LAS, and
# LAZ (whose host compression is the slow side) takes 2**22
SURVEY_DENSITY = 200.0
FILE_LAS_POINTS = 1 << 24
FILE_LAZ_POINTS = 1 << 22
FILE_CHUNK = 1 << 20
FILE_TILE = 512
FILE_DIR = "_file_to_map"     # under the checkout; removed after the phase
SURVEY_SCHEMA = PointSchema.from_attributes(
    [att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION])

# the format paths: make_survey's scene with colours and surface normals,
# written as .pnts three ways and (a part of it) as ASCII text
FORMATS_N = 1 << 22
FORMATS_ASCII_N = 1 << 18
FORMATS_ASCII = "xyzicRGB"
FORMATS_DIR = "_formats"      # under the checkout; removed after the phase
FORMATS_SCHEMA = PointSchema.from_attributes(
    [att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION,
     att.COLOR_RGB.with_dtype(dt.VEC3U8), att.NORMAL])
OCT16P_MAX_DEG = 2.0          # the oct16p bound of tests/test_ascii_tiles3d.py
# RANSAC: an airborne tile's ground plane and a power line, threshold and
# hypotheses as a user would ask for them; the CPU cross-check's size
SEG_PLANE_N = 1 << 22
SEG_LINE_N = 1 << 20
SEG_THRESHOLD = 0.05
SEG_PLANE_ITERS = 1024
SEG_LINE_ITERS = 256
SEG_CROSS_N = 1 << 16
SEG_BAND = 1e-5               # of the threshold: points this near it counted
EPS32 = 2.0 ** -24            # float32's unit roundoff
# convex hull: benches/host_benches.py's uniform cubes
HULL_SIZES = (1_000, 10_000, 100_000)

# the exact normals scan (benches/normals_bench.py --exact)
EXACT_N = 1 << 20
EXACT_K = 12
EXACT_ORACLE = 4096           # the bench's kd-tree subsample
EXACT_TILES = 8               # query tiles certified = exhaustive is held on
EXACT_CROSS_N = (1 << 16) + 1  # card against CPU, just over the gather cap

# the pose-graph sweep (benches/pose_graph_bench.py)
POSE_DENSE = (256, 1024, 2048)
POSE_CG = (1024, 5000, 10000, 20000)
POSE_ITERS = 3
POSE_CG_KW = {"cg_iterations": 600, "cg_tol": 1e-10}
POSE_AGREE_AT = 1024          # dense and CG solve the same graph here

# the closed trajectory: scans on a circle about the centre of a 64 m tile.
# The loop is defined for 32 scans (radius 1 m, yaw 3° sin(2 pi i / 32));
# fewer scans keep its step (~0.196 m, yaw <= 0.59°) on a smaller loop
TRAJ_LOOP = 32
TRAJ_SCANS = 8                # cut from 32 for the run's time: PERF.md
TRAJ_N = 1 << 20
TRAJ_SIZE = 64.0
TRAJ_RADIUS = 1.0
TRAJ_YAW_DEG = 3.0
# the walls turn 10° off the axes: a wall along a face of the map's voxel
# grid would count one layer of voxels or two by a millimetre of pose
TRAJ_WALL_YAW_DEG = 10.0
TRAJ_MEAN_M = 0.02            # gates, against the truth relative to pose 0
TRAJ_WORST_M = 0.05
TRAJ_ROT_DEG = 0.2
TRAJ_MAP_SHARE = 0.02         # map voxels against the true poses' map
# reprojection: a survey tile in ETRS89 / UTM 32N to WGS 84 and back
REPROJ_N = 1 << 22
REPROJ_SRC, REPROJ_DST = "EPSG:25832", "EPSG:4326"
GOLDEN = Path(__file__).resolve().parent / "tests" / "golden" / \
    "reprojection_golden.json"

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


def grid_anchor(batch: PointBatch, affine, shift: float = 0.0):
    """World bounds of the step's points and the grid anchor made from them.
    Returns ``(bmin, t)``, ``t`` the shifted translation."""
    scale, rot, t = affine
    t = t + shift
    wmin, _ = kernels.fused_world_bounds(batch.data[LOCAL], scale, rot, t)
    # grid anchored at leaf multiples in x (stripe boundaries stay
    # voxel-aligned) and at the z-translation (z-slab boundaries ditto);
    # the y anchor is data-driven
    return torch.stack([torch.floor(wmin[0] / LEAF) * LEAF, wmin[1],
                        t[2]]), t


def pipeline_head(batch: PointBatch, affine, shift: float = 0.0):
    """Bounds, grid anchor, base coefficients, keys and residual words of
    one step.  Returns ``(bmin, keys, rword, local_affine)``."""
    local = batch.data[LOCAL]
    scale, rot, _ = affine
    bmin, t = grid_anchor(batch, affine, shift)
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
    return voxel_downsample(attribute_batch(batch), LEAF, bounds=(bmin, None),
                            semantics="floor", grid_bits=10, sort_tiles=tiles,
                            precomputed=(keys, rword), local_affine=affine,
                            fused=fused)


def pipeline_batch(batch: PointBatch, affine, tiles: int,
                   shift: float = 0.0) -> PointBatch:
    """One exact transform + voxelize step, returning the voxel batch."""
    return pipeline_voxelize(batch, pipeline_head(batch, affine, shift),
                             tiles)


# ---- the three further paths ---------------------------------------------------

def attribute_batch(batch: PointBatch, world=None) -> PointBatch:
    """The batch without its local coordinates; with ``world`` as its f32
    position column."""
    data = {} if world is None else {POS: world}
    data.update((k, v) for k, v in batch.data.items() if k != LOCAL)
    return PointBatch(data, batch.count, batch.schema, batch.meta,
                      batch.policy)


def path_filter_grid(wbatch: PointBatch):
    """Path A on a batch of f32 world positions: drop one class, voxelize
    the rest on the generic 20-bit grid, and ask the result for its bounds
    and its intensity range.  Returns ``(kept, voxels, bounds, minmax)``."""
    kept = filter_batch(wbatch, lambda d: d[CLS] != 7)
    voxels = algorithms.voxelgrid_filter(kept, LEAF)
    return (kept, voxels, algorithms.calculate_bounds(voxels),
            algorithms.minmax_attribute(voxels, att.INTENSITY))


def quantized_head(batch: PointBatch, affine, shift: float = 0.0):
    """Path B's head: ``(bmin, keys, qword)``."""
    scale, rot, _ = affine
    bmin, t = grid_anchor(batch, affine, shift)
    keys, qword = kernels.fused_voxel_head(
        batch.data[LOCAL], scale, rot, t, bmin, LEAF, qbits=QBITS,
        semantics="floor")
    return bmin, keys, qword


def path_quantized(batch: PointBatch, head, tiles: int, fused: bool = True
                   ) -> PointBatch:
    """Path B (i): voxelize under the quantized head's keys and words."""
    bmin, keys, qword = head
    return voxel_downsample(
        attribute_batch(batch), LEAF, bounds=(bmin, None), semantics="floor",
        grid_bits=10, position_quantization_bits=QBITS, sort_tiles=tiles,
        precomputed=(keys, qword), fused=fused)


def path_quantized_internal(wbatch: PointBatch, bmin, tiles: int,
                            fused: bool = True) -> PointBatch:
    """Path B (ii): the same call without ``precomputed`` on a batch of f32
    world positions, which quantizes inside."""
    return voxel_downsample(
        wbatch, LEAF, bounds=(bmin, None), semantics="floor", grid_bits=10,
        position_quantization_bits=QBITS, sort_tiles=tiles, fused=fused)


def exact_f32_head(batch: PointBatch, affine, shift: float = 0.0):
    """Path C's head: ``(bmin, world, keys)``."""
    scale, rot, _ = affine
    bmin, t = grid_anchor(batch, affine, shift)
    world, keys = kernels.fused_decode_transform_key(
        batch.data[LOCAL], scale, rot, t, bmin, LEAF)
    return bmin, world, keys


def path_exact_f32(batch: PointBatch, head, tiles: int, fused: bool = True,
                   precomputed: bool = True) -> PointBatch:
    """Path C: voxelize the f32 world positions under the head's keys (or,
    with ``precomputed`` off, under keys made inside)."""
    bmin, world, keys = head
    return voxel_downsample(
        attribute_batch(batch, world), LEAF, bounds=(bmin, None),
        semantics="floor", grid_bits=10, sort_tiles=tiles,
        precomputed=(keys, None) if precomputed else None, fused=fused)


# ---- normals and registration ------------------------------------------------

def normals_surface(n: int = NORMALS_N, seed: int = 3) -> np.ndarray:
    """The surface of benches/normals_bench.py: ``xy ~ U(-100, 100)``,
    ``z = 0.4 sin(0.7x) + 0.3 cos(0.5y)``, (n, 3) f32."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-100, 100, (n, 2)).astype(np.float32)
    z = (0.4 * np.sin(xy[:, 0] * 0.7)
         + 0.3 * np.cos(xy[:, 1] * 0.5)).astype(np.float32)
    return np.stack([xy[:, 0], xy[:, 1], z], axis=1)


def within_degrees(normals: np.ndarray, pos: np.ndarray, deg: float = 6.0
                   ) -> float:
    """Share of unoriented normals within ``deg`` of the analytic normal of
    :func:`normals_surface` (the gate of benches/normals_bench.py)."""
    an = np.stack([-0.4 * 0.7 * np.cos(pos[:, 0] * 0.7),
                   0.3 * 0.5 * np.sin(pos[:, 1] * 0.5),
                   np.ones(pos.shape[0])], axis=1)
    an /= np.linalg.norm(an, axis=1, keepdims=True)
    dot = np.abs(np.sum(normals.astype(np.float64) * an, axis=1))
    return float((dot > np.cos(np.deg2rad(deg))).mean())


def positions_buffer(pos: np.ndarray) -> HostPointBuffer:
    schema = PointSchema.from_attributes([att.POSITION_3D])
    return HostPointBuffer(schema, {POS: pos.astype(np.float64)})


def path_normals(buf: HostPointBuffer, device=None):
    """Morton-window normals of a host buffer (``device=None``: the GPU)."""
    return algorithms.compute_normals(buf, NORMALS_K, method="morton",
                                      window=NORMALS_WINDOW, device=device)


def icp_scene(n: int = ICP_N, seed: int = 11) -> np.ndarray:
    """The scene of benches/icp_bench.py: rolling terrain plus two wall
    planes in a 200 m tile, (n, 3) f32."""
    rng = np.random.default_rng(seed)
    n_ground = n - (n // 8) * 2
    xy = rng.uniform(0, 200, (n_ground, 2)).astype(np.float32)
    z = (2.0 * np.sin(xy[:, 0] * 0.05) + 1.5 * np.cos(xy[:, 1] * 0.04)
         + rng.normal(0, 0.02, n_ground)).astype(np.float32)
    walls = []
    for x0 in (60.0, 140.0):
        yz = rng.uniform(0, 1, (n // 8, 2)).astype(np.float32)
        walls.append(np.stack([
            np.full(n // 8, x0, np.float32) + rng.normal(
                0, 0.02, n // 8).astype(np.float32),
            yz[:, 0] * 200, yz[:, 1] * 8], axis=1))
    return np.concatenate([np.stack([xy[:, 0], xy[:, 1], z], axis=1)]
                          + walls).astype(np.float32)


def icp_pair(n: int = ICP_N):
    """``(source, target)`` f32: the scene and its view under a 1° yaw
    about the scene's mean and a shift, row for row."""
    target = icp_scene(n)
    c, s = np.cos(ICP_THETA), np.sin(ICP_THETA)
    rot = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    mean = target.mean(0)
    source = ((target - mean) @ rot.T + mean + ICP_SHIFT).astype(np.float32)
    return source, target


def path_icp(source: torch.Tensor, target: torch.Tensor,
             point_to_plane: bool, iterations: int = ICP_ITERS):
    """Morton-correspondence ICP of ``source`` onto ``target``."""
    return icp(source, target, max_correspondence_distance=ICP_MAX_DIST,
               iterations=iterations, correspondence="morton",
               point_to_plane=point_to_plane)


def icp_residual(result, source: np.ndarray, target: np.ndarray) -> float:
    """Mean absolute residual of the rows after the estimated pose (rows
    correspond one to one)."""
    rot = result.rotation.cpu().numpy().astype(np.float64)
    t = result.translation.cpu().numpy().astype(np.float64)
    return float(np.abs(source @ rot.T + t - target).mean())


def scene_points(rng, n: int, lo: float, hi: float, walls,
                 wall_yaw_deg: float = 0.0) -> np.ndarray:
    """A terrain tile ``[lo, hi]²`` (``z = 0.5 sin 0.4x + 0.4 cos 0.3y``)
    with 3 m walls, each ``(axis, at)`` a plane across that axis with 1 cm
    of noise, ``n // (4 * len(walls))`` points each, turned ``wall_yaw_deg``
    about the vertical through the tile's centre; (n, 3) f64."""
    n_wall = n // (4 * len(walls))
    xy = rng.uniform(lo, hi, (n - len(walls) * n_wall, 2))
    z = 0.5 * np.sin(0.4 * xy[:, 0]) + 0.4 * np.cos(0.3 * xy[:, 1])
    parts = [np.stack([xy[:, 0], xy[:, 1], z], axis=1)]
    c, s_ = np.cos(np.deg2rad(wall_yaw_deg)), np.sin(np.deg2rad(wall_yaw_deg))
    mid = (lo + hi) / 2
    for axis, at in walls:
        uv = rng.uniform(0, 1, (n_wall, 2))
        across = at + rng.normal(0, 0.01, n_wall)
        along = lo + uv[:, 0] * (hi - lo)
        x, y = (across, along) if axis == 0 else (along, across)
        if wall_yaw_deg:
            x, y = (mid + c * (x - mid) - s_ * (y - mid),
                    mid + s_ * (x - mid) + c * (y - mid))
        parts.append(np.stack([x, y, uv[:, 1] * 3], axis=1))
    return np.concatenate(parts)


def registration_scans(scans: int = REG_SCANS, n: int = REG_N,
                       step: float = REG_STEP, seed: int = 13) -> list:
    """``scans`` views of one scene — a 24 m terrain tile with two walls
    across x — each shifted ``step`` m further along x, (n, 3) f64 each."""
    scene = scene_points(np.random.default_rng(seed), n, 0.0, 24.0,
                         ((0, 6.0), (0, 18.0)))
    return [scene + np.asarray([step * i, 0.0, 0.0]) for i in range(scans)]


def _unit(rng) -> np.ndarray:
    v = rng.normal(size=3)
    return v / np.linalg.norm(v)


def knock_keyframes(pipe: RegistrationPipeline, seed: int = 17) -> None:
    """Knock every keyframe but the first (the pose graph's anchor) off its
    odometry pose by a turn of ``REG_KNOCK_ROT`` and a shift of
    ``REG_KNOCK_T``, about and along seeded random directions."""
    rng = np.random.default_rng(seed)
    for kf in pipe.keyframes[1:]:
        turn = so3_exp(torch.from_numpy(_unit(rng) * REG_KNOCK_ROT)).numpy()
        kf.rotation = turn @ kf.rotation
        kf.translation = kf.translation + _unit(rng) * REG_KNOCK_T


def graph_cost(graph) -> float:
    """Total squared edge residual of a pose graph (unit weights)."""
    return float(torch.sum(edge_residuals(graph) ** 2))


def path_registration(scans: list, device=None, icp_iterations: int = 20):
    """``RegistrationPipeline`` over ``scans`` (default point-to-plane ICP
    on exact correspondences); then the keyframes are knocked off their
    odometry poses (:func:`knock_keyframes`) and ``optimize()`` brings them
    back.  Returns ``(pipeline, odometry poses (rotations, translations),
    knocked graph, its cost, the cost curve)``."""
    pipe = RegistrationPipeline(voxel_size=REG_VOXEL, keyframe_distance=0.05,
                                icp_iterations=icp_iterations, device=device)
    for s in scans:
        pipe.add_scan(s)
    odometry = (np.stack([kf.rotation for kf in pipe.keyframes]),
                pipe.trajectory())
    knock_keyframes(pipe)
    graph = pipe.graph()
    return pipe, odometry, graph, graph_cost(graph), pipe.optimize()


def pose_error(rotations: np.ndarray, translations: np.ndarray,
               odometry: tuple) -> float:
    """Largest deviation of poses from the odometry poses: rotation matrix
    entries and translations (m), whichever is larger."""
    return float(max(np.abs(rotations - odometry[0]).max(),
                     np.abs(translations - odometry[1]).max()))


def capture_compaction(scan: np.ndarray, device=None) -> tuple:
    """``(columns, mask, (compacted, count))``: what one ``_downsample``
    call of the pipeline hands K5 — the sorted voxel keys and the
    first-of-voxel mask — and what it returns."""
    seen = []

    def capture(cols, keep):
        out = compact_columns(cols, keep)
        seen.append((list(cols), keep, out))
        return out
    voxel_mod.compact_columns = capture
    try:
        RegistrationPipeline(voxel_size=REG_VOXEL,
                             device=device)._downsample(scan)
    finally:
        voxel_mod.compact_columns = compact_columns
    if len(seen) != 1:
        raise AssertionError(f"the downsampling compacted {len(seen)} times")
    return seen[0]


def held_compaction(scan: np.ndarray, device=None) -> int:
    """K5 held against its plain version on the inputs the pipeline's voxel
    downsampling of ``scan`` hands it (:func:`capture_compaction`).  Raises
    unless the kept counts and the compacted columns are equal; returns
    the kept count."""
    cols, keep, (got, count) = capture_compaction(scan, device)
    want, wcount = ck.blockwise_compact_plain(cols, keep)
    if int(count) != int(wcount):
        raise AssertionError(f"registration K5: {int(count)} kept, plain "
                             f"version {int(wcount)}")
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("registration K5: the compacted keys differ "
                             "from its plain version's")
    return int(count)


def trajectory_error(traj: np.ndarray, step: float = REG_STEP) -> float:
    """Largest deviation of the spacing of consecutive keyframes from
    ``step``."""
    return float(np.abs(np.linalg.norm(np.diff(traj, axis=0), axis=1)
                        - step).max())


# ---- exact normals at scale, the pose-graph sweep, the trajectory ----------

def kdtree_normals(pos: np.ndarray, sub: np.ndarray, k: int) -> np.ndarray:
    """The bench's host oracle: exact k-NN covariance normals of the rows
    ``sub`` from a ``scipy.spatial.cKDTree`` in f64."""
    from scipy.spatial import cKDTree
    _, idx = cKDTree(pos).query(pos[sub], k=k, workers=-1)
    neigh = pos[idx].astype(np.float64)
    c = neigh - neigh.mean(axis=1, keepdims=True)
    return np.linalg.eigh(np.einsum("nki,nkj->nij", c, c) / k)[1][:, :, 0]


def share_within(a: np.ndarray, b: np.ndarray, deg: float) -> float:
    """Share of unoriented normal pairs within ``deg`` degrees."""
    dot = np.abs(np.sum(a.astype(np.float64) * b, axis=1))
    return float((dot > np.cos(np.deg2rad(deg))).mean())


def exact_normals(pos: np.ndarray, device=None):
    """``compute_normals(method="exact")`` of a host buffer of ``pos``."""
    return algorithms.compute_normals(positions_buffer(pos), EXACT_K,
                                      method="exact", device=device)


def gate_normals_exact(pos: np.ndarray, nrm: np.ndarray, curv: np.ndarray
                       ) -> dict:
    """Gates 1 and 3 of ``path_normals_exact`` on a result of
    :func:`exact_normals`: more than 0.99 of the bench's kd-tree subsample
    within 1° of the host oracle; the share within 6° of the analytic
    normal (reported, as the bench does)."""
    n = pos.shape[0]
    if nrm.shape != (n, 3) or curv.shape != (n,) \
            or not (np.isfinite(nrm).all() and np.isfinite(curv).all()):
        raise AssertionError("path_normals_exact: bad shape or non-finite "
                             "values")
    sub = np.arange(0, n, max(n // EXACT_ORACLE, 1))
    oracle = share_within(nrm[sub], kdtree_normals(pos, sub, EXACT_K), 1.0)
    if not oracle > 0.99:
        raise AssertionError(f"path_normals_exact: {oracle} of the kd-tree "
                             f"subsample within 1° of the host oracle")
    return {"oracle_points": len(sub), "oracle_within_1deg": oracle,
            "analytic_within_6deg": within_degrees(nrm, pos)}


def check_certified(pos: np.ndarray, device=None, tiles: int = EXACT_TILES,
                    seed: int = 5) -> dict:
    """Gate 2 of ``path_normals_exact``: on the first query slice that
    ``compute_normals`` hands the scan, the certified scan of ``tiles``
    query tiles — the first, the last and seeded ones — equals the same
    code visiting every block (thresholds, normals, curvature, bit for
    bit)."""
    dev = resolve_device(device)
    p = torch.from_numpy(pos).to(dev)
    valid = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
    q = p[:normals_mod._EXACT_SLICE]
    nt = -(-q.shape[0] // 1024)
    rng = np.random.default_rng(seed)
    ids = sorted({0, nt - 1} | set(rng.choice(
        np.arange(1, max(nt - 1, 1)), size=min(tiles - 2, max(nt - 2, 0)),
        replace=False).tolist()))
    with fp32_matmul():
        cert = normals_mod._exact_scan(p, valid, EXACT_K, queries=q,
                                       tiles=ids)
        full = normals_mod._exact_scan(p, valid, EXACT_K, queries=q,
                                       tiles=ids, exhaustive=True)
    for what, a, b in zip(("thresholds", "normals", "curvature"), cert[1:4],
                          full[1:4]):
        if not torch.equal(a, b):
            raise AssertionError(
                f"path_normals_exact: certified {what} differ from the "
                f"exhaustive scan's on tiles {ids}")
    return {"tiles": ids, "certified_visits": cert[4].tolist(),
            "exhaustive_visits": full[4].tolist(),
            "certified_equals_exhaustive": True}


def cross_check_exact(n: int = EXACT_CROSS_N, device=None) -> dict:
    """Gate 4 of ``path_normals_exact``: the card against the CPU at ``n``
    points, both through the scan: more than 0.999 of the normals within 1°
    and of the curvatures within 1e-4."""
    pos = normals_surface(n)
    nrm, curv = exact_normals(pos, device)
    cnrm, ccurv = exact_normals(pos, "cpu")
    within = share_within(nrm, cnrm, 1.0)
    dc = np.abs(curv.astype(np.float64) - ccurv)
    curv_share = float((dc <= 1e-4).mean())
    if not (within > 0.999 and curv_share > 0.999):
        raise AssertionError(
            f"path_normals_exact: card against CPU at {n} points: {within} "
            f"of normals within 1°, {curv_share} of curvatures within 1e-4")
    return {"points": n, "within_1deg": within,
            "curvature_within_1e-4": curv_share,
            "max_curvature_diff": float(dc.max()),
            "normals_bit_equal": float(np.mean(np.all(nrm == cnrm, axis=1)))}


def circle_graph(n: int, seed: int = 11, drift: float = 0.02, device=None):
    """The graph of benches/pose_graph_bench.py: ``n`` poses on a 5 m
    circle, odometry edges with ``drift`` m of noise a step, exact loop
    closures from every third pose to pose 0, the chain-integrated start;
    a fresh ``default_rng(seed)`` per graph.  Returns ``(PoseGraph on
    device, true translations (n, 3))``."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    true_t = np.stack([np.cos(angles), np.sin(angles), np.zeros(n)],
                      axis=1) * 5.0
    edges, rel_t = [], []
    for i in range(n - 1):
        edges.append([i, i + 1])
        rel_t.append(true_t[i + 1] - true_t[i] + rng.normal(0, drift, 3))
    for i in range(3, n, 3):
        edges.append([i, 0])
        rel_t.append(true_t[0] - true_t[i])
    est_t = np.concatenate([true_t[:1], true_t[:1]
                            + np.cumsum(rel_t[:n - 1], axis=0)])
    dev = resolve_device(device)
    e = len(edges)

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device=dev)
    return PoseGraph(
        rotations=f64(np.broadcast_to(np.eye(3), (n, 3, 3))),
        translations=f64(est_t),
        edges=torch.as_tensor(edges, dtype=torch.int64, device=dev),
        rel_rotations=f64(np.broadcast_to(np.eye(3), (e, 3, 3))),
        rel_translations=f64(np.stack(rel_t))), true_t


def solve_circle(n: int, solver: str, device=None,
                 iterations: int = POSE_ITERS) -> dict:
    """One size of the pose-graph sweep: a warm solve, then a timed one
    (host clock to the cost read).  Gates: the final cost below the first
    iteration's, the ATE below the chain-integrated start's."""
    graph, true_t = circle_graph(n, device=device)
    kw = dict(iterations=iterations, solver=solver,
              **(POSE_CG_KW if solver == "cg" else {}))
    float(optimize_pose_graph(graph, **kw)[1][-1])
    t0 = time.perf_counter()
    opt, costs = optimize_pose_graph(graph, **kw)
    costs = costs.cpu().numpy()
    sec = time.perf_counter() - t0
    trans = opt.translations.cpu().numpy()
    ate0 = float(np.linalg.norm(graph.translations.cpu().numpy() - true_t,
                                axis=1).mean())
    ate = float(np.linalg.norm(trans - true_t, axis=1).mean())
    if not costs[-1] < costs[0]:
        raise AssertionError(f"path_pose_graph ({solver}, {n} poses): cost "
                             f"{costs.tolist()}")
    if not ate < ate0:
        raise AssertionError(f"path_pose_graph ({solver}, {n} poses): ATE "
                             f"{ate} m, start {ate0} m")
    return {"solver": solver, "poses": n, "edges": graph.num_edges,
            "ms_per_gn_iteration": sec / iterations * 1e3,
            "costs": costs.tolist(), "ate_start_m": ate0, "ate_m": ate,
            "translations": trans}


def gate_pose_graph(dense=POSE_DENSE, cg=POSE_CG, device=None,
                    agree_at: int = POSE_AGREE_AT) -> list:
    """The sweep: every size of each solver through :func:`solve_circle`,
    then dense and CG on the ``agree_at``-pose graph within 1e-6 m."""
    runs = [solve_circle(n, "dense", device) for n in dense] \
        + [solve_circle(n, "cg", device) for n in cg]
    pair = [r["translations"] for r in runs if r["poses"] == agree_at]
    gap = float(np.abs(pair[0] - pair[1]).max())
    if not gap <= 1e-6:
        raise AssertionError(f"path_pose_graph: dense and CG differ by {gap} "
                             f"m at {agree_at} poses")
    for r in runs:
        del r["translations"]
    return runs, gap


def trajectory_poses(scans: int = TRAJ_SCANS, radius: float = None,
                     yaw_deg: float = None):
    """A closed loop: scan i at angle ``2 pi i / scans`` on a circle of
    ``radius`` m about the tile's centre, yawed ``yaw_deg · sin`` of it; by
    default ``TRAJ_RADIUS`` and ``TRAJ_YAW_DEG`` scaled by ``scans /
    TRAJ_LOOP``, which keeps the 32-scan loop's step.  Returns
    ``(rotations (scans, 3, 3), translations (scans, 3))``."""
    if radius is None:
        radius = TRAJ_RADIUS * scans / TRAJ_LOOP
    if yaw_deg is None:
        yaw_deg = TRAJ_YAW_DEG * scans / TRAJ_LOOP
    a = 2 * np.pi * np.arange(scans) / scans
    yaw = np.deg2rad(yaw_deg) * np.sin(a)
    c, s_ = np.cos(yaw), np.sin(yaw)
    zero, one = np.zeros(scans), np.ones(scans)
    rot = np.stack([np.stack([c, -s_, zero], -1), np.stack([s_, c, zero], -1),
                    np.stack([zero, zero, one], -1)], -2)
    return rot, np.stack([radius * np.cos(a), radius * np.sin(a), zero], -1)


def trajectory_scan(i: int, poses, n: int = TRAJ_N,
                    size: float = TRAJ_SIZE) -> np.ndarray:
    """Scan i: a fresh draw (seed 13 + i) of a ``size`` m terrain tile
    centred on the origin with walls across x and y at a quarter of the
    tile from its centre, in the scan's own frame (the inverse of its true
    pose); (n, 3) f64."""
    q = size / 4
    world = scene_points(np.random.default_rng(13 + i), n, -size / 2,
                         size / 2, ((0, -q), (0, q), (1, -q), (1, q)),
                         TRAJ_WALL_YAW_DEG)
    rot, t = poses[0][i], poses[1][i]
    return (world - t) @ rot


def path_trajectory(scans, device=None, icp_iterations: int = 20):
    """``RegistrationPipeline`` over ``scans`` (every scan a keyframe),
    ``add_loop_closure(0, last)`` by ICP and ``optimize(10)``.  Returns
    ``(pipeline, odometry poses, cost curve, seconds)``: each scan's
    downsampling (with its host round trip) and ICP, and the loop closure
    and pose graph, timed on the host clock (each returns numpy)."""
    pipe = RegistrationPipeline(voxel_size=REG_VOXEL, keyframe_distance=0.05,
                                icp_iterations=icp_iterations, device=device)
    sec = {"downsample": [], "icp": []}

    def timed(name, fn):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            sec[name].append(time.perf_counter() - t0)
            return out
        return run
    pipe._downsample = timed("downsample", pipe._downsample)
    pipe._align = timed("icp", pipe._align)
    count = 0
    for scan in scans:
        pipe.add_scan(scan)
        count += 1
    odometry = (np.stack([kf.rotation for kf in pipe.keyframes]),
                pipe.trajectory())
    t0 = time.perf_counter()
    pipe.add_loop_closure(0, len(pipe.keyframes) - 1)
    costs = pipe.optimize(10)
    sec["pose_graph"] = time.perf_counter() - t0
    del pipe._downsample, pipe._align
    return pipe, odometry, costs, sec


def pose_errors(rotations: np.ndarray, translations: np.ndarray, poses
                ) -> dict:
    """Keyframe poses against the truth relative to pose 0: mean and worst
    translation error (m), worst rotation error (degrees)."""
    r0, t0 = poses[0][0], poses[1][0]
    true_r = np.einsum("ji,njk->nik", r0, poses[0])
    true_t = (poses[1] - t0) @ r0
    dt_ = np.linalg.norm(translations - true_t, axis=1)
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): well conditioned at small
    # angles, where the trace's arccos loses them under f32 rounding
    chord = np.linalg.norm(rotations - true_r, axis=(1, 2)) / np.sqrt(8.0)
    ang = 2.0 * np.arcsin(np.clip(chord, 0.0, 1.0))
    return {"mean_m": float(dt_.mean()), "worst_m": float(dt_.max()),
            "rotation_deg": float(np.rad2deg(ang.max()))}


def true_map_count(pipe: RegistrationPipeline, poses) -> int:
    """Voxels of ``map_points()`` with every keyframe at its true pose
    relative to pose 0 (the keyframes' own poses restored after)."""
    r0, t0 = poses[0][0], poses[1][0]
    kept = [(kf.rotation, kf.translation) for kf in pipe.keyframes]
    try:
        for kf, rot, t in zip(pipe.keyframes, poses[0], poses[1]):
            kf.rotation, kf.translation = r0.T @ rot, r0.T @ (t - t0)
        return len(pipe.map_points())
    finally:
        for kf, (rot, t) in zip(pipe.keyframes, kept):
            kf.rotation, kf.translation = rot, t


def gate_trajectory(pipe: RegistrationPipeline, poses, scans: int) -> dict:
    """The trajectory's gates: every scan a keyframe; after the loop
    closure and the pose graph, mean and worst translation error and the
    rotation error within ``TRAJ_*``; the map's voxel count within
    ``TRAJ_MAP_SHARE`` of the same map from the true poses."""
    if len(pipe.keyframes) != scans:
        raise AssertionError(f"path_trajectory: {len(pipe.keyframes)} "
                             f"keyframes of {scans} scans")
    out = pose_errors(np.stack([kf.rotation for kf in pipe.keyframes]),
                      pipe.trajectory(), poses)
    out["map_voxels"] = len(pipe.map_points())
    out["true_map_voxels"] = true_map_count(pipe, poses)
    if not (out["mean_m"] <= TRAJ_MEAN_M and out["worst_m"] <= TRAJ_WORST_M
            and out["rotation_deg"] <= TRAJ_ROT_DEG
            and abs(out["map_voxels"] - out["true_map_voxels"])
            <= TRAJ_MAP_SHARE * out["true_map_voxels"]):
        raise AssertionError(f"path_trajectory: {out}")
    return out


# ---- merging tiles -------------------------------------------------------------

def concat_batches(device=None, seed: int = 41) -> list:
    """``CONCAT_BATCHES`` padded batches of ``CONCAT_CAPACITY`` rows, each
    filled to between half and all of it (seeded), with LAS locals,
    Intensity and Classification made on ``device`` (``None``: the GPU).
    The padding rows hold random data too: none of it may reach the
    merged batch."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    counts = rng.integers(CONCAT_CAPACITY // 2, CONCAT_CAPACITY + 1,
                          CONCAT_BATCHES)
    gen = torch.Generator(device=dev).manual_seed(seed)
    schema = PointSchema.from_attributes(
        [LAS_LOCAL, att.INTENSITY, att.CLASSIFICATION])
    cap = CONCAT_CAPACITY

    def rand(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, dtype=dtype, device=dev,
                             generator=gen)
    return [PointBatch.from_columns(schema, {
        LOCAL: rand(-2_000_000, 2_000_000, (cap, 3), torch.int32),
        INT: rand(0, 65536, (cap,), torch.int32),
        CLS: rand(0, 32, (cap,), torch.uint8)}, count=int(c), device=dev)
        for c in counts]


def batches_on(batches: list, device) -> list:
    """The same batches, copied to ``device``."""
    return [PointBatch({k: v.to(device) for k, v in b.data.items()},
                       b.count.to(device), b.schema, b.meta, b.policy)
            for b in batches]


def path_concat_convert(batches: list):
    """Merge the batches (valid rows first, in order), convert the merged
    batch to ``CONVERT_SCHEMA``, and encode the f64 world positions of its
    LAS locals back to locals.  Returns ``(merged, converted, encoded)``."""
    merged = PointBatch.concatenate(batches)
    conv = convert_batch_schema(merged, CONVERT_SCHEMA,
                                fill_missing_with_default=True)
    dev = merged.device
    scale = torch.from_numpy(LAS_SCALE).to(dev)
    offset = torch.from_numpy(LAS_OFFSET).to(dev)
    world = decode_las_positions(conv.data[LOCAL], scale, offset,
                                 dtype=torch.float64)
    return merged, conv, encode_las_positions(world, scale, offset,
                                              rounding="round")


# ---- the file -> map path -----------------------------------------------------

def _morton_u64(cell: np.ndarray) -> np.ndarray:
    """63-bit Morton code of (n, 3) cells of up to 20 bits (the bench's)."""
    def expand(v):
        v = v.astype(np.uint64) & np.uint64(0xFFFFF)
        v = (v | (v << np.uint64(32))) & np.uint64(0xFFFF00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x00FF0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0xF00F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x30C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x9249249249249249)
        return v
    return (expand(cell[:, 0]) | (expand(cell[:, 1]) << np.uint64(1))
            | (expand(cell[:, 2]) << np.uint64(2)))


def make_survey(n: int, seed: int = 11) -> HostPointBuffer:
    """``benches/end_to_end_bench.py``'s survey: a square of SURVEY_DENSITY
    points a square metre, gentle terrain with per-point noise, Morton-
    ordered as survey archives are; Intensity uniform in [0, 4096) and
    Classification a function of x."""
    rng = np.random.default_rng(seed)
    side = float(np.sqrt(n / SURVEY_DENSITY))
    xy = rng.uniform(0, side, (n, 2))
    z = (4.0 * np.sin(xy[:, 0] * 0.02) + 3.0 * np.cos(xy[:, 1] * 0.017)
         + rng.normal(0, 0.05, n) + 50.0)
    pos = np.stack([xy[:, 0], xy[:, 1], z], axis=1)
    pmin = pos.min(0)
    ext = (pos.max(0) - pmin).max()
    cell = np.clip((pos - pmin) / ext * (1 << 20), 0,
                   (1 << 20) - 1).astype(np.uint64)
    order = np.argsort(_morton_u64(cell), kind="stable")
    inten = rng.integers(0, 4096, n).astype(np.uint16)
    cls = ((cell[order, 0] >> np.uint64(13)) % np.uint64(7)).astype(np.uint8)
    return HostPointBuffer.from_columns(SURVEY_SCHEMA, {
        POS: pos[order], INT: inten, CLS: cls})


def file_fold(path, device=None, **kw):
    """The fold of the bench: ``streaming_voxel_downsample`` of the file
    in FILE_CHUNK chunks, tiles of FILE_TILE rows, a 10-bit grid anchored
    at the header's bounds."""
    return streaming.streaming_voxel_downsample(
        path, LEAF, chunk_points=FILE_CHUNK, grid_bits=10,
        use_metadata_bounds=True, sort_tiles=FILE_CHUNK // FILE_TILE,
        schema=SURVEY_SCHEMA, device=device, **kw)


def header_min(path, device=None) -> np.ndarray:
    """The fold's grid anchor: the minimum of the header's bounds or,
    where the format's header holds none (``.pnts``), of the streamed
    bounds, as ``streaming_voxel_downsample`` takes them."""
    with open_reader(path) as r:
        bounds = r.get_metadata().bounds()
    if bounds is None:
        bounds = streaming.streaming_bounds(path, FILE_CHUNK, device=device)
    return np.asarray(bounds.min, np.float32)


def one_shot(path, device=None):
    """The whole file read as one batch and voxelized with one global sort
    in plain PyTorch (``sort_tiles=1``, ``fused=False``), with its merge
    statistics (keys, counts); returns ``((batch, aux), f64 positions)``."""
    buf = read_all(path, SURVEY_SCHEMA)
    batch = PointBatch.from_host(buf, device=device)
    bmin = torch.from_numpy(header_min(path, batch.device)).to(batch.device)
    return voxel_downsample(batch, LEAF, bounds=(bmin, None),
                            semantics="floor", grid_bits=10, with_aux=True,
                            fused=False), buf.get(POS)


def survey_oracle(pos64: np.ndarray, gmin: np.ndarray):
    """``(keys, f64 means)`` of every voxel, in key order: cells from the
    f32 positions as the device computes them, means of the f64 ones."""
    u = (pos64.astype(np.float32) - gmin) / np.float32(LEAF)
    cell = np.clip(np.floor(u), 0, 1023).astype(np.uint64)
    keys, inverse, counts = np.unique(_morton_u64(cell).astype(np.int64),
                                      return_inverse=True,
                                      return_counts=True)
    return keys, np.stack([np.bincount(inverse, weights=pos64[:, a])
                           for a in range(3)], axis=1) / counts[:, None]


def compare_folds(what: str, got, ref) -> None:
    """Two folds' results equal bit for bit: the count, every column and
    the cell keys and counts."""
    (gb, ga), (rb, ra) = got, ref
    if int(gb.count.item()) != int(rb.count.item()):
        raise AssertionError(f"{what}: {int(gb.count.item())} voxels, "
                             f"reference {int(rb.count.item())}")
    for name, col in rb.data.items():
        if not torch.equal(gb.data[name], col):
            raise AssertionError(f"{what}: column {name} differs")
    if not (torch.equal(ga["keys"][0], ra["keys"][0])
            and torch.equal(ga["counts"], ra["counts"])):
        raise AssertionError(f"{what}: cell keys or counts differ")


def gate_file_to_map(path, device=None) -> dict:
    """The fold with run tables against a one-shot voxelization of the
    whole file: equal voxel count, cell keys, point counts and
    Classification; Intensity within 1; centroids within 1e-4 m + 1e-6 of
    the one-shot's and within 5e-4 m of an f64 oracle; no truncated run
    table.  Then the default fold (the top-2 vote): its Classification
    mismatches with the one-shot as a share.  Returns the readings."""
    kernels.reset_launch_counts()
    fb, fa = file_fold(path, device=device, mode_runs=True, with_aux=True)
    runs_launches = kernels.launch_counts()
    (ob, oa), pos64 = one_shot(path, device=device)
    nv = int(fb.count.item())
    if nv == 0 or nv != int(ob.count.item()):
        raise AssertionError(f"file -> map: {nv} voxels, one-shot "
                             f"{int(ob.count.item())}")
    if not (torch.equal(fa["keys"][0][:nv], oa["keys"][0][:nv])
            and torch.equal(fa["counts"][:nv], oa["counts"][:nv])):
        raise AssertionError("file -> map: cell keys or point counts differ "
                             "from the one-shot's")
    if not torch.equal(fb.data[CLS][:nv], ob.data[CLS][:nv]):
        raise AssertionError("file -> map: Classification differs from the "
                             "one-shot's")
    dint = (fb.data[INT][:nv] - ob.data[INT][:nv]).abs().max().item()
    if dint > 1:
        raise AssertionError(f"file -> map: Intensity differs by {dint}")
    got, ref = fb.data[POS][:nv], ob.data[POS][:nv]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("file -> map: non-finite centroids")
    excess = ((got - ref).abs() - (1e-4 + 1e-6 * ref.abs())).max().item()
    if excess > 0:
        raise AssertionError(f"file -> map: centroids off the one-shot's by "
                             f"{excess} m beyond 1e-4 m + 1e-6")
    err_one = (got - ref).abs().max().item()
    truncated = [n for n, rt in fa["mode_runs"].items()
                 if bool(rt["input_truncated"].item())]
    if truncated:
        raise AssertionError(f"file -> map: truncated run tables {truncated}")
    okeys, omeans = survey_oracle(pos64, header_min(path, device))
    if not np.array_equal(okeys, fa["keys"][0][:nv].cpu().numpy()):
        raise AssertionError("file -> map: cell keys differ from the f64 "
                             "oracle's")
    err_oracle = float(np.abs(got.cpu().numpy().astype(np.float64)
                              - omeans).max())
    if not err_oracle < 5e-4:
        raise AssertionError(f"file -> map: a centroid is {err_oracle} m "
                             f"from the f64 oracle")
    vote = file_fold(path, device=device)
    if int(vote.count.item()) != nv:
        raise AssertionError("file -> map: the default fold counts "
                             f"{int(vote.count.item())} voxels")
    miss = (vote.data[CLS][:nv] != ob.data[CLS][:nv]).sum().item()
    return {"voxels": nv, "gate_passed": True,
            "max_err_vs_one_shot": err_one,
            "max_intensity_diff": dint, "max_err_vs_f64_oracle": err_oracle,
            "top2_vote_classification_mismatch_share": miss / nv,
            "mode_runs_fold_launches": {
                k: runs_launches[k] for k in ("tile_sort",
                                              "blockwise_compact")}}


def upload_ms(path, device, reps: int = 5) -> float:
    """Median ms of one chunk's upload by the fold's read-ahead: into a
    pinned buffer, then to the card on the upload stream."""
    with open_reader(path) as r:
        buf = r.read(FILE_CHUNK, SURVEY_SCHEMA)
    up = streaming._PinnedUpload(device, FILE_CHUNK,
                                  dt.DevicePolicy.NARROW)
    times = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        _, event = up(buf)
        event.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def host_read_s(path) -> float:
    """Seconds of the host's converting read of the whole file in chunks
    (the bench's ``host_read_row``)."""
    t0 = time.perf_counter()
    with open_reader(path) as r:
        while len(r.read(FILE_CHUNK, SURVEY_SCHEMA)):
            pass
    return time.perf_counter() - t0


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
    """The CUDA kernels (one ``nvcc`` per source, side by side) and, at the
    same time, the LASzip codec (``g++``).  A codec that does not build
    fails the run: the reader would otherwise fall back to numpy."""
    t0 = time.perf_counter()

    def build_codec() -> float:
        laszip._native(required=True)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=1) as ex:
        codec = ex.submit(build_codec)
        _build.build_all()
        kernels_s = time.perf_counter() - t0
        codec_s = codec.result()
    print(json.dumps({"phase": "build", "sources": sorted(_build.SOURCES),
                      "seconds": kernels_s,
                      "codec": "pasture_tpu_torch/native/src/laszip.cpp",
                      "codec_seconds": codec_s,
                      "total_seconds": time.perf_counter() - t0}),
          flush=True)


def _pack_word(batch: PointBatch) -> torch.Tensor:
    """The packed word of the main path: Classification (u8, mode) in the
    top 8 bits, Intensity (u16, mean) below it."""
    return ((batch.data[att.CLASSIFICATION.name].to(torch.int64) << 24)
            | (batch.data[att.INTENSITY.name].to(torch.int64) << 8))


_FIELDS = ((8, 16, False, 0, 65535),)   # Intensity in the packed word
_MODE_BITS = 8                          # Classification

#: kernel row name -> (the phase whose run its ``launches`` is read from,
#: its key in ``kernels.launch_counts()``)
ROW_PATH = {}
_CSRC = "pasture_tpu_torch/ops/kernels/csrc/"
_TPU = "pasture_tpu/ops/kernels/"


def read_launches(rows: list, path: str, counts: dict) -> None:
    """Write the launch counts of ``path``'s run into its kernels' rows;
    fail if the path launched one of them no time."""
    for r in rows:
        on_path, counter = ROW_PATH[r["name"]]
        if on_path == path:
            r["launches"] = counts[counter]
            if r["launches"] < 1:
                raise AssertionError(f"{path} never launched {r['name']}")


def expect_launched(path: str, counts: dict, *counters: str) -> None:
    for c in counters:
        if counts[c] < 1:
            raise AssertionError(f"{path} never launched {c}")


def assert_same_voxels(what: str, got: PointBatch, ref: PointBatch,
                       atol: float) -> float:
    """Count and integer columns equal, centroids within ``atol``, rows past
    the count zero.  Returns the largest centroid difference."""
    nv = int(got.count.item())
    if nv == 0 or nv != int(ref.count.item()):
        raise AssertionError(f"{what}: {nv} voxels, reference "
                             f"{int(ref.count.item())}")
    for name in (INT, CLS):
        if not torch.equal(got.data[name][:nv], ref.data[name][:nv]):
            raise AssertionError(f"{what}: column {name} differs")
    if not bool(torch.isfinite(got.data[POS][:nv]).all()):
        raise AssertionError(f"{what}: non-finite centroids")
    err = (got.data[POS][:nv] - ref.data[POS][:nv]).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{what}: centroids differ by {err}")
    if bool((got.data[POS][nv:] != 0).any()):
        raise AssertionError(f"{what}: rows past count are not zero")
    return err


def step_ms(fn, warmup: int = 2, reps: int = 7):
    """``(median, min, max)`` ms of ``fn(i)`` as a caller sees it: events
    around each call, host launch gaps included."""
    times = []
    for i in range(warmup + reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(i)
        e1.record()
        e1.synchronize()
        if i >= warmup:
            times.append(e0.elapsed_time(e1))
    return float(np.median(times)), float(min(times)), float(max(times))


def check_tile_sort(streams: list, tile_len: int, num_keys: int = 2):
    """``tile_sort`` by its first ``num_keys`` streams against its plain
    version: key streams bit-exact; per tile the multiset of rows equal (the
    sort is unstable: rows with equal keys may come in any order).  Returns
    the kernel's streams and the largest key difference."""
    what = f"tile_sort ({len(streams)} streams, {num_keys} keys, " \
           f"{tile_len}-row tiles)"
    got = kernels.tile_sort(streams, tile_len, num_keys=num_keys)
    want = ts.tile_sort_plain(streams, tile_len, num_keys=num_keys)
    torch.cuda.synchronize()
    gotc = [u32_carrier(s) for s in got]
    dkey = max((gotc[i] - want[i]).abs().max().item()
               for i in range(num_keys))
    if dkey:
        raise AssertionError(f"{what}: key streams differ by {dkey}")
    full_g = ts.lex_order(gotc, tile_len)
    full_w = ts.lex_order(list(want), tile_len)
    for g, w in zip(gotc, want):
        if not torch.equal(g[full_g], w[full_w]):
            raise AssertionError(f"{what}: a tile's rows are not a "
                                 f"permutation of its input rows")
    return got, dkey


SWEEP_TILE_LENS = (2, 32, 64, 256, 512, 1024, 4096)
SWEEP_TILES = 320            # 64 tiles of each of the five kinds below


def sweep_streams(tile_len: int, tiles: int = SWEEP_TILES, seed: int = 19
                  ) -> list:
    """Five u32 streams (bits form, int32) of ``tiles`` tiles of adversarial
    rows, tile ``t`` of kind ``t % 5``: keys from a small range (repeats);
    all keys equal; all keys 0xFFFFFFFF; rows in descending order; keys
    and words with the top bit set.  Streams 2-4 are distinct payloads, so
    a lost or doubled row shows."""
    rng = np.random.default_rng(seed + tile_len)
    n = tiles * tile_len
    kind = np.repeat(np.arange(tiles) % 5, tile_len)
    pos = np.tile(np.arange(tile_len, dtype=np.uint64), tiles)
    key = rng.integers(0, 16, n).astype(np.uint64)
    word = rng.integers(0, 1 << 32, n, dtype=np.uint64) & 0xFF0000FF
    key[kind == 1] = 7
    key[kind == 2] = 0xFFFFFFFF
    desc = (kind == 3)
    key[desc] = (tile_len - pos[desc]) // 3 + (1 << 31)
    word[desc] = 0xFFFFFFFF - pos[desc]
    top = kind == 4
    key[top] |= 0x80000000
    word[top] |= 0x80000000
    out = [key, word] + [rng.integers(0, 1 << 32, n, dtype=np.uint64)
                         for _ in range(3)]
    return [torch.from_numpy(s.astype(np.uint32).view(np.int32))
            for s in out]


def phase_tile_sort_sweep(dev: torch.device) -> None:
    """K4 against its plain version over every tile length the kernel
    family has a code path for, every stream count and key count, on
    :func:`sweep_streams`: key streams bit-exact, every tile a permutation
    of its rows."""
    t0 = time.perf_counter()
    checks = 0
    for tile_len in SWEEP_TILE_LENS:
        streams = [s.to(dev) for s in sweep_streams(tile_len)]
        for n_streams in range(1, 6):
            for num_keys in (1, 2):
                if num_keys <= n_streams:
                    check_tile_sort(streams[:n_streams], tile_len, num_keys)
                    checks += 1
    print(json.dumps({"phase": "tile_sort_sweep",
                      "tile_lens": list(SWEEP_TILE_LENS),
                      "tiles": SWEEP_TILES, "checks": checks,
                      "all_equal": True,
                      "seconds": time.perf_counter() - t0}), flush=True)


SWEEP_KS = (1, 8, 9, 10, 12, 16, 17, 32)
SWEEP_WS = (1, 16, 64, 500, 1920)


def sweep_window_inputs(w: int, seed: int = 23):
    """K6's inputs for the sweep at window ``w``: ``(sp, pp)`` f32, with
    ``n`` not a multiple of the kernel's queries per block.  Three regions
    of queries: points of a coarse integer lattice (many ties at the k-th
    distance) with a tenth of the rows exact duplicates of their
    predecessor; points within 3e-23 of the origin (offset products
    underflow to -0.0 and +0.0); and a run of ``2w + 9`` invalid
    candidates, so that some windows hold no finite candidate.  2 % of the
    other candidates are invalid too."""
    rng = np.random.default_rng(seed + w)
    lat = rng.integers(0, 4, (1000, 3)).astype(np.float32)
    dup = rng.random(1000) < 0.1
    dup[0] = False
    lat[dup] = lat[np.flatnonzero(dup) - 1]
    tiny = rng.uniform(-3e-23, 3e-23, (1000, 3)).astype(np.float32)
    run = rng.uniform(0, 4, (2 * w + 9, 3)).astype(np.float32)
    tail = rng.integers(0, 4, (38, 3)).astype(np.float32)    # n odd
    sp = np.concatenate([lat, tiny, run, tail])
    cand = np.where(rng.random((sp.shape[0], 1)) < 0.02, np.inf, sp)
    cand[2000:2000 + run.shape[0]] = np.inf
    pad = np.full((w, 3), np.inf, np.float32)
    pp = np.concatenate([pad, cand, pad]).astype(np.float32)
    return torch.from_numpy(sp), torch.from_numpy(pp)


def phase_window_fit_sweep(dev: torch.device) -> None:
    """K6 against its plain version, every output bit for bit, over every
    k in ``SWEEP_KS`` and window in ``SWEEP_WS`` on
    :func:`sweep_window_inputs`."""
    t0 = time.perf_counter()
    checks = 0
    for w in SWEEP_WS:
        sp, pp = (a.to(dev) for a in sweep_window_inputs(w))
        for k in SWEEP_KS:
            got = wf.window_fit_moments(sp, pp, k, w)
            want = wf.window_fit_moments_plain(sp, pp, k, w)
            torch.cuda.synchronize()
            for name, g, p in zip(("cnt", "tight", "s", "m6"), got, want):
                if not torch.equal(g.view(torch.int32), p.view(torch.int32)):
                    raise AssertionError(
                        f"window_fit_moments (k={k}, w={w}): {name} differs "
                        f"from the plain version's bits")
            checks += 1
    print(json.dumps({"phase": "window_fit_sweep", "ks": list(SWEEP_KS),
                      "windows": list(SWEEP_WS), "checks": checks,
                      "all_equal_bitwise": True,
                      "seconds": time.perf_counter() - t0}), flush=True)


REDUCE_SWEEP_TILE_LENS = (1, 3, 16, 17, 100, 512, 1000, 4096)
REDUCE_SWEEP_CHUNKS = 320    # chunks of whole tiles a call: 40 CTAs of 512-row chunks
REDUCE_SWEEP_KINDS = 7
_INVALID = 0xFFFFFFFF


def _sweep_field(shift: int, width: int, signed: bool) -> tuple:
    """A mean field with the clip bounds of its integer type."""
    lo, hi = ((-(1 << (width - 1)), (1 << (width - 1)) - 1) if signed
              else (0, (1 << width) - 1))
    return shift, width, signed, lo, hi


#: (mode_bits, fields) of the reduce sweep: no fields; four narrow fields
#: of widths 1-12 under an 8-bit mode; a signed 24-bit field; a 32-bit
#: mode; 32-bit fields, unsigned (tile sums pass 2**31 and 2**32) and
#: signed, which take the 64-bit sums; a 31-bit field (32-bit sums only
#: for one-row tiles)
REDUCE_SWEEP_WORDS = (
    (0, ()),
    (8, (_sweep_field(0, 1, False), _sweep_field(1, 7, True),
         _sweep_field(8, 12, False), _sweep_field(20, 4, True))),
    (8, (_sweep_field(0, 24, True),)),
    (32, ()),
    (0, (_sweep_field(0, 32, False),)),
    (0, (_sweep_field(0, 32, True),)),
    (0, (_sweep_field(0, 31, False),)),
)


def reduce_sweep_streams(tile_len: int, tiles: int, seed: int = 29):
    """K3's adversarial inputs: numpy ``(key, word, rword)`` u32 and ``pos``
    f32 ``(n, 3)``, every tile sorted by (key, word) as the tile sort
    leaves it.  Tile ``t`` is of kind ``t % 7``: random runs; one run over
    the whole tile, its words all >= 2**31; all keys distinct; all keys
    invalid; runs of 16 rows on 16-row boundaries; runs of 32 rows whose
    last third is invalid; runs of 32 rows shifted by one (each crosses a
    32-row boundary).  Words repeat their predecessor 40 % of the time and
    half of them have a top byte of 0-2 (mode ties); positions are NaN in
    invalid rows."""
    rng = np.random.default_rng(seed + tile_len)
    n = tiles * tile_len
    tile = np.repeat(np.arange(tiles), tile_len)
    kind = tile % REDUCE_SWEEP_KINDS
    r = np.tile(np.arange(tile_len), tiles)
    run = np.select(
        [kind == 0, kind == 2, kind == 4, kind == 5, kind == 6],
        [rng.integers(0, tile_len // 3 + 2, n), r, r // 16, r // 32,
         (r + 1) // 32], default=0)
    key = (rng.integers(0, 1 << 28, tiles)[tile]
           + run * rng.integers(1, 8, tiles)[tile]).astype(np.uint64)
    key[(kind == 3) | ((kind == 5) & (3 * r >= 2 * tile_len))] = _INVALID
    word = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    low = rng.random(n) < 0.5
    word[low] = (word[low] & 0xFFFFFF) | (
        rng.integers(0, 3, int(low.sum())).astype(np.uint64) << 24)
    src = np.where(rng.random(n) < 0.4, 0, np.arange(n))
    word = word[np.maximum.accumulate(src)]
    word[kind == 1] |= 0x80000000
    order = np.lexsort((word, key, tile))
    key, word = key[order], word[order]
    rword = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    pos = rng.uniform(-1000, 1000, (n, 3)).astype(np.float32)
    pos[key == _INVALID] = np.nan
    return (key.astype(np.uint32), word.astype(np.uint32),
            rword.astype(np.uint32), pos)


def check_reduce(streams, tile_len: int, mode_bits: int, fields, form: str,
                 local_affine=None, qbits: int = 10) -> int:
    """K3 in one form against its plain version: count and ``out_word``
    exact; centroids bit for bit (exact-local, quantized) or within atol
    1e-5 + rtol 1e-6 (exact-f32); rows past the count zero in both.
    ``streams``: torch ``(key, word, rword, pos)``.  Returns the count."""
    key, word, rword, pos = streams
    bmin = torch.tensor([-3.0, 2.0, 1.0], device=key.device)
    what = (f"fused_sorted_voxel_reduce ({form}, tile_len={tile_len}, "
            f"mode_bits={mode_bits}, fields={fields})")
    kw = {}
    if form == "exact_f32":
        kw["spos"] = tuple(pos[:, a].contiguous() for a in range(3))
        args = (key, word, None, bmin, LEAF, mode_bits, fields, 0, 1.0,
                tile_len, "floor")
    else:
        if form == "exact_local":
            kw["local_affine"] = local_affine
        args = (key, word, rword, bmin, LEAF, mode_bits, fields, qbits, 1.0,
                tile_len, "floor")
    gpos, gword, gcount = vr.fused_sorted_voxel_reduce_rows(*args, **kw)
    ppos, pword, pcount = vr.fused_sorted_voxel_reduce_plain(*args, **kw)
    torch.cuda.synchronize()
    nv = int(gcount.item())
    if nv != int(pcount.item()):
        raise AssertionError(f"{what}: {nv} voxels, plain "
                             f"{int(pcount.item())}")
    if not torch.equal(u32_carrier(gword), pword):
        raise AssertionError(f"{what}: out_word differs")
    if form == "exact_f32":
        same = torch.allclose(gpos, ppos, rtol=1e-6, atol=1e-5)
    else:
        same = torch.equal(gpos.view(torch.int32), ppos.view(torch.int32))
    if not same:
        raise AssertionError(f"{what}: centroids differ by "
                             f"{(gpos - ppos).abs().max().item()}")
    return nv


def phase_voxel_reduce_sweep(dev: torch.device, affine) -> None:
    """K3, all three forms, against its plain version over every tile
    length in ``REDUCE_SWEEP_TILE_LENS`` and every word layout in
    ``REDUCE_SWEEP_WORDS``, on :func:`reduce_sweep_streams`."""
    t0 = time.perf_counter()
    coeffs = kernels.exact_local_base_coeffs(
        SCALE, ROT, TRANS, torch.zeros(3, device=dev), LEAF, "floor")
    local_affine = (*affine, coeffs)
    checks, sums = 0, {"int32": 0, "int64": 0}
    for tile_len in REDUCE_SWEEP_TILE_LENS:
        tiles = REDUCE_SWEEP_CHUNKS * max(1, vr.CHUNK_ROWS // tile_len)
        key, word, rword, pos = reduce_sweep_streams(tile_len, tiles)
        streams = tuple(torch.from_numpy(a.view(np.int32)).to(dev)
                        for a in (key, word, rword)) + (
            torch.from_numpy(pos).to(dev),)
        for mode_bits, fields in REDUCE_SWEEP_WORDS:
            if fields:
                sums["int32" if vr.narrow_field_sums(fields, tile_len)
                     else "int64"] += 1
            for form, qbits in (("exact_local", 10), ("quantized", 7),
                                ("exact_f32", 0)):
                check_reduce(streams, tile_len, mode_bits, fields, form,
                             local_affine, qbits)
                checks += 1
    if not (sums["int32"] and sums["int64"]):
        raise AssertionError(f"the sweep missed an accumulator width: {sums}")
    print(json.dumps({"phase": "voxel_reduce_sweep",
                      "tile_lens": list(REDUCE_SWEEP_TILE_LENS),
                      "chunks": REDUCE_SWEEP_CHUNKS,
                      "word_layouts": len(REDUCE_SWEEP_WORDS),
                      "field_sum_layouts": sums, "checks": checks,
                      "all_equal": True,
                      "seconds": time.perf_counter() - t0}), flush=True)


COMPACT_SWEEP_NS = (1, 31, 2047, 2048, 2049, 65536, 4194303)
COMPACT_SWEEP_KEEPS = ("all", "none", "alternate", "10%", "90%")
#: (dtype, elements a row, element offset of the column's first row): rows
#: of 1, 2, 3, 4, 8, 12, 16 and 17 bytes, four columns starting at an odd
#: element; nine columns, so one call makes two write launches
COMPACT_SWEEP_COLS = ((torch.uint8, 1, 0), (torch.int16, 1, 1),
                      (torch.uint8, 3, 1), (torch.int32, 1, 0),
                      (torch.int64, 1, 0), (torch.int32, 3, 1),
                      (torch.int32, 4, 0), (torch.uint8, 17, 1),
                      (torch.int32, 3, 0))


#: rows wider than one launch takes (``ck.LAUNCH_ROW_BYTES``), which the
#: kernel moves as byte slices: (dtype, elements a row, element offset), a
#: 40 000-byte row, a 40 001-byte row at an odd offset and a 73 220-byte
#: row in 4-byte units at an odd element, beside a 12-byte column
COMPACT_SWEEP_WIDE_COLS = ((torch.uint8, 40_000, 0), (torch.uint8, 40_001, 1),
                           (torch.int32, 18_305, 1), (torch.int32, 3, 0))
#: a 36 609-byte row: its second slice's launch stages two rows a part, so
#: the spread launch's blocks of threads take parts of more than one row
COMPACT_SWEEP_SPLIT_COLS = ((torch.uint8, 36_609, 3), (torch.int16, 5, 1))
COMPACT_SWEEP_WIDE_NS = (1, 2047, 2049, 3000)


def compact_sweep_inputs(n: int, keep: str, dev, gen,
                         layout=COMPACT_SWEEP_COLS):
    """Random columns of ``layout`` (views into larger buffers where the
    offset is odd) and the mask of kind ``keep``."""
    cols = []
    for dt_, per, off in layout:
        size = torch.empty((), dtype=dt_).element_size()
        raw = torch.randint(0, 256, ((n * per + off) * size,),
                            dtype=torch.uint8, device=dev, generator=gen)
        flat = raw.view(dt_)[off:off + n * per]
        cols.append(flat if per == 1 else flat.view(n, per))
    idx = torch.arange(n, device=dev)
    mask = {"all": idx >= 0, "none": idx < 0, "alternate": idx % 2 == 0,
            "10%": torch.rand(n, device=dev, generator=gen) < 0.1,
            "90%": torch.rand(n, device=dev, generator=gen) < 0.9}[keep]
    return cols, mask


def check_compact(cols, mask, layout, what: str) -> None:
    """K5 against its plain version: the count, every kept row and the
    zero tail, byte for byte; one kernel call."""
    before = kernels.launch_counts()["blockwise_compact"]
    got, gcount = ck.blockwise_compact(cols, mask)
    if kernels.launch_counts()["blockwise_compact"] != before + 1:
        raise AssertionError(f"blockwise_compact ({what}) did not launch")
    want, wcount = ck.blockwise_compact_plain(cols, mask)
    torch.cuda.synchronize()
    if int(gcount.item()) != int(wcount.item()):
        raise AssertionError(f"blockwise_compact ({what}): "
                             f"{int(gcount.item())} kept, plain "
                             f"{int(wcount.item())}")
    for (dt_, per, off), g, w in zip(layout, got, want):
        if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
            raise AssertionError(f"blockwise_compact ({what}): the column "
                                 f"of {per} x {dt_} at offset {off} differs")


def phase_compact_sweep(dev: torch.device) -> None:
    """K5 against its plain version over ``COMPACT_SWEEP_NS`` x
    ``COMPACT_SWEEP_KEEPS`` on nine columns of every row width, and over
    ``COMPACT_SWEEP_WIDE_NS`` x the masks on rows wider than one launch
    takes: the count, every kept row and the zero tail, byte for byte."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(31)
    checks = 0
    for layout, ns in ((COMPACT_SWEEP_COLS, COMPACT_SWEEP_NS),
                       (COMPACT_SWEEP_WIDE_COLS, COMPACT_SWEEP_WIDE_NS),
                       (COMPACT_SWEEP_SPLIT_COLS, COMPACT_SWEEP_WIDE_NS)):
        for n in ns:
            for keep in COMPACT_SWEEP_KEEPS:
                cols, mask = compact_sweep_inputs(n, keep, dev, gen, layout)
                check_compact(cols, mask, layout, f"n={n}, keep {keep}")
                checks += 1
                del cols, mask

    def widths(layout):
        return [torch.empty((), dtype=dt_).element_size() * per
                for dt_, per, _ in layout]
    seconds = time.perf_counter() - t0
    # the wide-row route's time at the largest wide case, 90 % kept,
    # beside its plain version's and its bound (bytes: the mask, every row
    # read once, every output row written once)
    n = max(COMPACT_SWEEP_WIDE_NS)
    cols, mask = compact_sweep_inputs(n, "90%", dev, gen,
                                      COMPACT_SWEEP_WIDE_COLS)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    wide_ms = gpu_ms(lambda: ck.blockwise_compact(cols, mask), flush,
                     warmup=1, reps=3)
    plain_ms = gpu_ms(lambda: ck.blockwise_compact_plain(cols, mask), flush,
                      warmup=1, reps=3)
    del cols, mask, flush
    print(json.dumps({"phase": "compact_sweep", "ns": list(COMPACT_SWEEP_NS),
                      "keeps": list(COMPACT_SWEEP_KEEPS),
                      "row_bytes": widths(COMPACT_SWEEP_COLS),
                      "wide_ns": list(COMPACT_SWEEP_WIDE_NS),
                      "wide_row_bytes": widths(COMPACT_SWEEP_WIDE_COLS)
                      + widths(COMPACT_SWEEP_SPLIT_COLS),
                      "launch_row_bytes": ck.LAUNCH_ROW_BYTES,
                      "checks": checks, "all_equal": True,
                      "seconds": seconds,
                      "wide_rows": n, "wide_ms": wide_ms,
                      "wide_plain_ms": plain_ms,
                      "wide_bound_ms": bound(n + 2.0 * n * sum(
                          widths(COMPACT_SWEEP_WIDE_COLS)), 0)[0]}),
          flush=True)


WB_SWEEP_NS = (1, 2, 3, 4, 5, 255, 256, 257, 4095, 4097, 65537, 4194303,
               4194304, 4194305)
#: an LAS local far outside the sweep's points: after the step's rotation
#: it is the largest world x and z and the smallest world y (its negation
#: the opposite)
WB_EXTREME = (3_000_000, -3_000_000, 2_500_000)


def check_world_bounds(local, params, what: str) -> None:
    """K1 twice (its ticket must be back at zero after each call) against
    its plain version, ``torch.equal``."""
    want = torch.cat(ft.fused_world_bounds_plain(local, *params))
    for rep in range(2):
        got = torch.cat(kernels.fused_world_bounds(local, *params))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fused_world_bounds ({what}, call "
                                 f"{rep + 1}): {got} != plain {want}")


def phase_world_bounds_sweep(dev: torch.device, affine) -> None:
    """K1 against its plain version, bit for bit, over ``WB_SWEEP_NS``
    points on views 0-3 rows into one buffer (12 B a row, so 1-3 rows off
    start off a 16-byte boundary and take the kernel's scalar head), with
    no extreme point and with ``WB_EXTREME`` (and its negation) first,
    last and in the scalar tail; each case called twice; device and host
    (numpy) parameters; and every point count once on a second stream."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(37)
    pool = torch.randint(-200_000, 200_000, (max(WB_SWEEP_NS) + 3, 3),
                         dtype=torch.int32, device=dev, generator=gen)
    host = (SCALE, ROT, np.asarray([10.0, -5.0, 2.0], np.float32))
    side = torch.cuda.Stream(device=dev)
    checks = 0
    for n in WB_SWEEP_NS:
        for off in range(4):
            local = pool[off:off + n]
            head = min(n, (local.data_ptr() & 15) >> 2)
            tail0 = head + (n - head) // 4 * 4
            places = {"first": 0, "last": n - 1}
            if tail0 < n:
                places["tail"] = tail0
            check_world_bounds(local, affine, f"n={n}, +{off} rows")
            checks += 1
            for where, i in places.items():
                saved = local[i].clone()
                for sign in (1, -1):
                    local[i] = torch.tensor(WB_EXTREME, device=dev) * sign
                    params = host if sign < 0 else affine
                    check_world_bounds(local, params,
                                       f"n={n}, +{off} rows, extreme "
                                       f"{sign:+d} {where}")
                    checks += 1
                local[i] = saved
        local = pool[:n]
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            check_world_bounds(local, affine, f"n={n}, second stream")
        checks += 1
    print(json.dumps({"phase": "world_bounds_sweep",
                      "ns": list(WB_SWEEP_NS), "row_offsets": [0, 1, 2, 3],
                      "checks": checks, "calls_per_check": 2,
                      "workspaces": len(ft._BOUNDS_WORK),
                      "all_equal_bitwise": True,
                      "seconds": time.perf_counter() - t0}), flush=True)


def add_row(rows: list, name, source, replaces, err, ms, plain_ms, n_bytes,
            n_ops, library_ms=None, path="main_path", counter=None) -> None:
    """Append a kernel row; its ``launches`` are read from ``path``'s run
    (``counter``: its key in ``kernels.launch_counts()``)."""
    b_ms, by = bound(n_bytes, n_ops)
    ROW_PATH[name] = (path, counter or name)
    rows.append({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": 0,
                 "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms})


def phase_kernels(batch: PointBatch, affine, tiles: int) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    dev = batch.device
    scale, rot, t = affine
    local = batch.data[LOCAL]
    n = local.shape[0]
    tile_len = n // tiles
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def row(*args, **kw):
        add_row(rows, *args, **kw)

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
    got, dkey = check_tile_sort(streams, tile_len)
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

    # K3: count, out_word and centroids bit-exact — the same f32
    # operations on exact integer sums
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
    if not torch.equal(kpos.view(torch.int32), ppos.view(torch.int32)):
        raise AssertionError(f"fused_sorted_voxel_reduce: centroids differ "
                             f"by {err}")
    row("fused_sorted_voxel_reduce",
        "pasture_tpu_torch/ops/kernels/csrc/voxel_reduce.cu",
        "pasture_tpu/ops/kernels/voxel_reduce_kernel.py:415", err,
        gpu_ms(lambda: vr.fused_sorted_voxel_reduce_rows(
            *rargs, local_affine=local_affine), flush),
        gpu_ms(lambda: vr.fused_sorted_voxel_reduce_plain(
            *rargs, local_affine=local_affine), flush, reps=5),
        # 12 B read per row, 16 B written per output row (every voxel and
        # every zeroed row past the count, each once), 4 B per tile;
        # ~24 integer operations per row, ~80 per voxel
        12.0 * n + 16.0 * n + 4.0 * tiles, 24.0 * n + 80.0 * nv)

    # K5: kept rows, count and zero tail equal to the plain version, on the
    # filter path's columns (12-, 4- and 1-byte rows) at ~90 % kept
    gen = torch.Generator(device=dev).manual_seed(11)
    keep = torch.rand(n, device=dev, generator=gen) < 0.9
    ccols = [local, batch.data[INT], batch.data[CLS]]
    got, gcount = ck.blockwise_compact(ccols, keep)
    want, wcount = ck.blockwise_compact_plain(ccols, keep)
    torch.cuda.synchronize()
    kept = int(gcount.item())
    if kept != int(wcount.item()):
        raise AssertionError(f"blockwise_compact: {kept} kept, plain "
                             f"{int(wcount.item())}")
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError("blockwise_compact differs from its plain "
                                 "version")
    row_bytes = sum(c.numel() // n * c.element_size() for c in ccols)
    row("blockwise_compact", _CSRC + "compact.cu",
        _TPU + "compact_kernel.py:135", 0.0,
        gpu_ms(lambda: ck.blockwise_compact(ccols, keep), flush),
        gpu_ms(lambda: ck.blockwise_compact_plain(ccols, keep), flush,
               reps=5),
        # the mask and every row read once, every output row written once
        # (the kept rows and the zero tail); a ballot, a popcount and a few
        # adds per row, one move per 4 bytes of a kept row
        n + 2.0 * row_bytes * n, 12.0 * n + row_bytes / 4.0 * kept,
        # one boolean-index call per column; each waits for the host to
        # learn the size, and that wait is in the time
        library_ms=gpu_ms(lambda: [c[keep] for c in ccols], flush, reps=5),
        path="path_filter_grid")
    del got, want

    # K7a: keys and residual words bit-exact, both semantics
    for sem in ("nearest", "floor"):
        qargs = (local, scale, rot, t, bmin, LEAF, QBITS, sem)
        qkeys, qword = kernels.fused_voxel_head(*qargs)
        pk, pq = ft.fused_voxel_head_plain(*qargs)
        torch.cuda.synchronize()
        dk = (u32_carrier(qkeys) - pk).abs().max().item()
        dq = (u32_carrier(qword) - pq).abs().max().item()
        if dk or dq:
            raise AssertionError(f"fused_voxel_head ({sem}) differs from "
                                 f"its plain version: key {dk}, qword {dq}")
    row("fused_voxel_head", _CSRC + "voxel_head.cu",
        _TPU + "fused_transform.py:440", max(dk, dq),
        gpu_ms(lambda: kernels.fused_voxel_head(*qargs), flush),
        gpu_ms(lambda: ft.fused_voxel_head_plain(*qargs), flush, reps=5),
        # 12 B read + 8 B written per point; transform 24, cells 18, Morton
        # spread 41, residuals and packing 23
        20.0 * n, 106.0 * n, path="path_quantized")

    # K7b: keys and world positions bit-exact
    dargs = (local, scale, rot, t, bmin, LEAF)
    world, dkeys = kernels.fused_decode_transform_key(*dargs)
    pworld, pkeys = ft.fused_decode_transform_key_plain(*dargs)
    torch.cuda.synchronize()
    dk = (u32_carrier(dkeys) - pkeys).abs().max().item()
    dw = (world - pworld).abs().max().item()
    if dk or dw:
        raise AssertionError(f"fused_decode_transform_key differs from its "
                             f"plain version: key {dk}, world {dw}")
    del pworld, pkeys
    row("fused_decode_transform_key", _CSRC + "voxel_head.cu",
        _TPU + "fused_transform.py:108", max(dk, dw),
        gpu_ms(lambda: kernels.fused_decode_transform_key(*dargs), flush),
        gpu_ms(lambda: ft.fused_decode_transform_key_plain(*dargs), flush,
               reps=5),
        # 12 B read + 16 B written per point; transform 24, cells 12,
        # Morton spread 41
        28.0 * n, 77.0 * n, path="path_exact_f32")

    # K3'q: the quantized form on the tile-sorted (key, word, qword) of the
    # floor head — count, out_word and centroids bit-exact (integer sums,
    # then the same f32 operations)
    qs = kernels.tile_sort([u32_bits(qkeys), u32_bits(word),
                            u32_bits(qword)], tile_len, num_keys=2)
    qargs3 = (qs[0], qs[1], qs[2], bmin, LEAF, _MODE_BITS, _FIELDS, QBITS,
              1.0, tile_len, "floor")
    kpos, kword, kcount = vr.fused_sorted_voxel_reduce_rows(*qargs3)
    ppos, pword, pcount = vr.fused_sorted_voxel_reduce_plain(*qargs3)
    torch.cuda.synchronize()
    nvq = int(kcount.item())
    if nvq != int(pcount.item()) \
            or not torch.equal(u32_carrier(kword), pword):
        raise AssertionError("fused_sorted_voxel_reduce (quantized): count "
                             "or out_word differs from the plain version")
    err = (kpos - ppos).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"fused_sorted_voxel_reduce (quantized): "
                             f"centroids differ by {err}")
    del ppos, pword
    row("fused_sorted_voxel_reduce_quantized", _CSRC + "voxel_reduce.cu",
        _TPU + "voxel_reduce_kernel.py:415", err,
        gpu_ms(lambda: vr.fused_sorted_voxel_reduce_rows(*qargs3), flush),
        gpu_ms(lambda: vr.fused_sorted_voxel_reduce_plain(*qargs3), flush,
               reps=5),
        12.0 * n + 16.0 * n + 4.0 * tiles, 24.0 * n + 40.0 * nvq,
        path="path_quantized")

    # K4 at five streams (key, word | x, y, z as their bits): key streams
    # bit-exact, every tile's rows the same multiset
    wbits = [world[:, a].contiguous().view(torch.int32) for a in range(3)]
    streams5 = [u32_bits(dkeys), u32_bits(word)] + wbits
    got5, dkey5 = check_tile_sort(streams5, tile_len)
    packed5 = ((u32_carrier(dkeys) << 32) | word).reshape(tiles, tile_len)
    w2 = [b.reshape(tiles, tile_len) for b in wbits]

    def library_sort5():
        srt = torch.sort(packed5, dim=1)
        return srt.values, [b.gather(1, srt.indices) for b in w2]

    row("tile_sort_5_streams", _CSRC + "tile_sort.cu",
        _TPU + "tile_sort_kernel.py:132", dkey5,
        gpu_ms(lambda: kernels.tile_sort(streams5, tile_len, num_keys=2),
               flush),
        gpu_ms(lambda: ts.tile_sort_plain(streams5, tile_len, num_keys=2),
               flush, reps=5),
        # 20 B read + 20 B written per row; per compare-exchange 4 compares
        # of the two key words and 10 moves of the five streams
        40.0 * n, 14.0 * stages * (n // 2),
        library_ms=gpu_ms(library_sort5, flush, reps=5),
        path="path_exact_f32", counter="tile_sort")

    # K3'f: the exact-f32 form — count and out_word exact; centroids within
    # atol 1e-5 + rtol 1e-6 of the plain version: both sum a voxel's f32
    # positions in f64 and round once, the kernel serially, the plain
    # version through index_add_ in the order the atomics happen to take
    spos = tuple(u32_bits(s).view(torch.float32) for s in got5[2:])
    fargs = (got5[0], got5[1], None, bmin, LEAF, _MODE_BITS, _FIELDS, 0, 1.0,
             tile_len, "floor")
    kpos, kword, kcount = vr.fused_sorted_voxel_reduce_rows(*fargs, spos=spos)
    ppos, pword, pcount = vr.fused_sorted_voxel_reduce_plain(*fargs,
                                                             spos=spos)
    torch.cuda.synchronize()
    nvf = int(kcount.item())
    if nvf != int(pcount.item()) \
            or not torch.equal(u32_carrier(kword), pword):
        raise AssertionError("fused_sorted_voxel_reduce (exact f32): count "
                             "or out_word differs from the plain version")
    if not torch.allclose(kpos, ppos, rtol=1e-6, atol=1e-5):
        raise AssertionError("fused_sorted_voxel_reduce (exact f32): "
                             "centroids differ from the plain version")
    err = (kpos - ppos).abs().max().item()
    del ppos, pword
    row("fused_sorted_voxel_reduce_exact_f32", _CSRC + "voxel_reduce.cu",
        _TPU + "voxel_reduce_kernel.py:415", err,
        gpu_ms(lambda: vr.fused_sorted_voxel_reduce_rows(*fargs, spos=spos),
               flush),
        gpu_ms(lambda: vr.fused_sorted_voxel_reduce_plain(*fargs, spos=spos),
               flush, reps=5),
        20.0 * n + 16.0 * n + 4.0 * tiles, 24.0 * n + 40.0 * nvf,
        path="path_exact_f32")
    del got5, kpos, spos

    # K6 at the normals path's shape (the surface in Morton order, 2 % of
    # the candidates inf) and at the point-to-plane ICP's (the target scene,
    # k = 10, w = 64): every output bit-exact (both passes compute d2 by
    # one expression, -fmad=false, the same additions in the same order)
    for name, pos, k, invalid, path in (
            ("window_fit_moments", normals_surface(), NORMALS_K, 0.02,
             "path_normals"),
            ("window_fit_moments_icp", icp_scene(), ICP_NORMALS_K, 0.0,
             "path_icp")):
        w = NORMALS_WINDOW
        sp, pp = window_fit_inputs(torch.from_numpy(pos).to(dev), invalid)
        got = wf.window_fit_moments(sp, pp, k, w)
        want = wf.window_fit_moments_plain(sp, pp, k, w)
        torch.cuda.synchronize()
        err = max((g - p).abs().max().item() for g, p in zip(got, want))
        if not all(torch.equal(g.view(torch.int32), p.view(torch.int32))
                   for g, p in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version by "
                                 f"{err}")
        nq = sp.shape[0]
        selected = float(got[0].sum().item())
        row(name, _CSRC + "window_fit.cu", _TPU + "window_fit_kernel.py:214",
            err, gpu_ms(lambda: wf.window_fit_moments(sp, pp, k, w), flush),
            gpu_ms(lambda: wf.window_fit_moments_plain(sp, pp, k, w), flush,
                   warmup=1, reps=3),
            # 12 B query + 12 B candidate read, 44 B written per query.
            # The work these inputs need, each operation counted once at
            # the float32 rate: per query and shift d2 (8) and one compare
            # in each pass; 2k * k to fill the k sorted registers; ~20 per
            # selected candidate (this run's count, the kernel's own cnt)
            68.0 * nq + 24.0 * w,
            nq * ((2.0 * w + 1) * 10 + 2.0 * k * k) + 20.0 * selected,
            path=path, counter="window_fit_moments")
        del sp, pp, got, want
    icp_step_rows(rows, dev, flush)
    return rows


def icp_step_inputs(n: int, dev):
    """K8's inputs at ``n`` x ``n``: :func:`icp_pair`'s clouds (the source
    a 1° turn and a shift off the target), every row valid, unit normals
    drawn from a seed (K8a reads only the matched row's), the identity."""
    src, tgt = (torch.from_numpy(a).to(dev) for a in icp_pair(n))
    gen = torch.Generator(device=dev).manual_seed(8)
    nrm = torch.randn((n, 3), generator=gen, device=dev)
    nrm = (nrm / torch.linalg.norm(nrm, dim=1, keepdim=True)).contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    pose = torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0, 0, 0, 0],
                        dtype=torch.float32, device=dev)
    return src, valid, tgt, valid, nrm, pose


def icp_step_rows(rows: list, dev, flush) -> None:
    """K8a and K8b against their plain versions at :data:`ICP_STEP_SHAPES`
    (point-to-plane, ``ICP_MAX_DIST``): K8a's partials and the pose K8b
    writes from them equal bit for bit, then timed."""
    for suffix, n in ICP_STEP_SHAPES:
        args = icp_step_inputs(n, dev)
        max_d2 = ICP_MAX_DIST ** 2
        got = ist.icp_correspond_accumulate(*args, max_d2, True)
        want = ist.icp_correspond_accumulate_plain(*args, max_d2, True)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
            raise AssertionError(f"icp_correspond_accumulate{suffix} "
                                 f"differs from its plain version by {err}")
        big = n > 1 << 16
        pose = args[5]
        add_row(rows, "icp_correspond_accumulate" + suffix,
                _CSRC + "icp_step.cu", "none (XLA's loop)", err,
                gpu_ms(lambda: ist.icp_correspond_accumulate(
                    *args, max_d2, True), flush, reps=3 if big else 10),
                gpu_ms(lambda: ist.icp_correspond_accumulate_plain(
                    *args, max_d2, True), flush, warmup=0 if big else 2,
                    reps=1 if big else 5),
                # the source rows and mask, the target rows, mask and
                # normals read once, the partials written
                13.0 * n + 25.0 * n + 8.0 * got.numel(),
                ICP_STEP_PAIR_OPS * n * n, path="path_trajectory",
                counter="icp_correspond_accumulate")
        kpose, ppose = pose.clone(), pose.clone()
        ist.icp_solve_update(got, kpose, 1e-6)
        ist.icp_solve_update_plain(want, ppose, 1e-6)
        torch.cuda.synchronize()
        err = (kpose - ppose).abs().max().item()
        if not torch.equal(kpose.view(torch.int32), ppose.view(torch.int32)):
            raise AssertionError(f"icp_solve_update{suffix} differs from "
                                 f"its plain version by {err}")
        work = pose.clone()
        add_row(rows, "icp_solve_update" + suffix, _CSRC + "icp_step.cu",
                "none (XLA's loop)", err,
                gpu_ms(lambda: ist.icp_solve_update(got, work, 1e-6), flush),
                gpu_ms(lambda: ist.icp_solve_update_plain(
                    want, work.clone(), 1e-6), flush, reps=5),
                # the partials read, the pose and two scalars written
                8.0 * got.numel() + 56.0, 30.0 * got.shape[1] + 400.0,
                path="path_trajectory", counter="icp_solve_update")
        del args, got, want


def window_fit_inputs(pos: torch.Tensor, invalid: float = 0.02,
                      seed: int = 5):
    """K6's inputs as a Morton curve hands them over: ``pos`` in the order
    of its first Morton curve, and the candidate array padded by the
    window's inf rows a side, with ``invalid`` of the rows inf."""
    valid = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    lo = pos.amin(dim=0)
    sp = pos[normals_mod.morton_order(pos, valid, lo,
                                      (pos.amax(dim=0) - lo).max())]
    gen = torch.Generator(device=pos.device).manual_seed(seed)
    cand = torch.rand(pos.shape[0], device=pos.device,
                      generator=gen) >= invalid
    pad = torch.full((NORMALS_WINDOW, 3), float("inf"), device=pos.device)
    return sp, torch.cat([pad, torch.where(cand[:, None], sp,
                                           torch.full_like(sp, float("inf"))),
                          pad])


def tile_groups(keys: np.ndarray, tile_len: int) -> np.ndarray:
    """Id of every row's (tile, voxel) group, ascending in (tile, Morton
    key) order."""
    return (np.arange(keys.shape[0], dtype=np.int64) // tile_len) << 32 \
        | keys.astype(np.int64)


def group_means_f64(group: np.ndarray, values: np.ndarray) -> np.ndarray:
    """f64 mean of ``values`` (n, 3) over equal ``group`` ids, in ascending
    id order."""
    _, inverse, counts = np.unique(group, return_inverse=True,
                                   return_counts=True)
    return np.stack([np.bincount(inverse, weights=values[:, a].astype(
        np.float64)) for a in range(3)], axis=1) / counts[:, None]


def f64_oracle(local: np.ndarray, keys: np.ndarray, tile_len: int
               ) -> np.ndarray:
    """Centroid of every (tile, voxel) group in f64: the affine image of
    the exact mean of the i32 locals, in (tile, Morton key) order."""
    mean = group_means_f64(tile_groups(keys, tile_len), local)
    return (mean * SCALE.astype(np.float64)) @ ROT.astype(np.float64).T \
        + TRANS


def phase_main_path(batch: PointBatch, affine, local_np: np.ndarray,
                    tiles: int, rows: list, smi: str) -> None:
    n = batch.capacity
    kernels.reset_launch_counts()
    head = pipeline_head(batch, affine)
    out = pipeline_voxelize(batch, head, tiles)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    read_launches(rows, "main_path", counts)                    # check (c)

    nv = int(out.count.item())
    got_pos = out.data[POS][:nv]
    if not bool(torch.isfinite(got_pos).all()) or nv == 0:
        raise AssertionError("main path: no voxels or non-finite centroids")

    # (a) the package's generic exact-local path, plain PyTorch on the GPU
    ref = pipeline_voxelize(batch, head, tiles, fused=False)
    if int(ref.count.item()) != nv:
        raise AssertionError(f"main path: {nv} voxels, generic path "
                             f"{int(ref.count.item())}")
    for name in (INT, CLS):
        if not torch.equal(out.data[name][:nv], ref.data[name][:nv]):
            raise AssertionError(f"main path: column {name} differs from "
                                 f"the generic path")
    err_generic = (got_pos - ref.data[POS][:nv]).abs().max().item()
    if not err_generic <= 1e-4:
        raise AssertionError(f"main path: centroids differ from the generic "
                             f"path by {err_generic}")
    if bool((out.data[POS][nv:] != 0).any()):
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
    sub = PointBatch({INT: batch.data[INT][:m], CLS: batch.data[CLS][:m],
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
    ms, lo, hi = step_ms(lambda i: pipeline_batch(
        batch, affine, tiles, shift=(i % 7) * 1e-6), warmup=3, reps=10)
    print(json.dumps({
        "phase": "main_path", "points": n, "tiles": tiles, "voxels": nv,
        "launches": counts, "max_err_vs_generic_path": err_generic,
        "max_err_vs_f64_oracle": err_oracle, "oracle_tiles": tiles,
        "step_ms": ms, "step_ms_min": lo, "step_ms_max": hi, "repeats": 10,
        "mpoints_per_s": n / ms / 1e3, "card": smi}), flush=True)


def max_dist(got: torch.Tensor, oracle: np.ndarray, what: str) -> float:
    if oracle.shape[0] != got.shape[0]:
        raise AssertionError(f"{what}: {got.shape[0]} voxels, oracle "
                             f"{oracle.shape[0]}")
    return float(np.linalg.norm(
        got.cpu().numpy().astype(np.float64) - oracle, axis=1).max())


def phase_path_filter_grid(wbatch: PointBatch, rows: list, smi: str) -> None:
    """Path A at the full batch, checked, counted, timed."""
    n = wbatch.capacity
    kernels.reset_launch_counts()
    kept, voxels, box, (imin, imax) = path_filter_grid(wbatch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    read_launches(rows, "path_filter_grid", counts)

    # the filter against boolean indexing: kept rows in order, zero tail
    keep = wbatch.data[CLS] != 7
    nk = int(kept.count.item())
    if nk != int(keep.sum().item()) or not 0 < nk < n:
        raise AssertionError(f"path_filter_grid: {nk} rows kept")
    for name, col in wbatch.data.items():
        if not torch.equal(kept.data[name][:nk], col[keep]) \
                or bool((kept.data[name][nk:] != 0).any()):
            raise AssertionError(f"path_filter_grid: filtered column {name} "
                                 f"differs from boolean indexing")
    # the voxel grid against the generic path in plain PyTorch all the way
    # (f32 sums by atomics in another order: 1e-4 of coordinates ~150)
    ref = voxel_downsample(kept, LEAF, fused=False)
    err_generic = assert_same_voxels("path_filter_grid", voxels, ref, 1e-4)
    del ref
    # and an f64 oracle: the mean position of every cell of the 20-bit
    # nearest-marker grid anchored at the data minimum, in Morton order
    nv = int(voxels.count.item())
    pos = kept.data[POS][:nk]
    cells = voxel_indices(pos, torch.ones(nk, dtype=torch.bool,
                                          device=pos.device), LEAF,
                          pos.amin(dim=0), "nearest", 20).cpu().numpy()
    code = morton_encode_u64(cells[:, 0], cells[:, 1], cells[:, 2])
    err_oracle = max_dist(voxels.data[POS][:nv],
                          group_means_f64(code, pos.cpu().numpy()),
                          "path_filter_grid")
    if not err_oracle < 5e-4:
        raise AssertionError(f"path_filter_grid: a centroid is {err_oracle} "
                             f"from the f64 oracle")
    # bounds and min/max of the result, by numpy on the copied columns
    vpos = voxels.data[POS][:nv].cpu().numpy()
    vint = voxels.data[INT][:nv].cpu().numpy()
    if not (np.array_equal(box.min, vpos.min(axis=0).astype(np.float64))
            and np.array_equal(box.max, vpos.max(axis=0).astype(np.float64))
            and imin == vint.min() and imax == vint.max()):
        raise AssertionError("path_filter_grid: bounds or min/max differ "
                             "from numpy's")

    ms, lo, hi = step_ms(lambda i: path_filter_grid(wbatch), reps=5)
    print(json.dumps({
        "phase": "path_filter_grid", "points": n, "kept": nk, "voxels": nv,
        "launches": counts, "max_err_vs_generic_path": err_generic,
        "max_err_vs_f64_oracle": err_oracle, "step_ms": ms,
        "step_ms_min": lo, "step_ms_max": hi, "repeats": 5,
        "mpoints_per_s": n / ms / 1e3, "card": smi}), flush=True)


def phase_path_quantized(batch: PointBatch, wbatch: PointBatch, affine,
                         tiles: int, rows: list, smi: str) -> None:
    """Path B at the full batch: (i) head kernel + precomputed words,
    (ii) the internal quantizer; each checked, counted, timed."""
    n = batch.capacity
    tile_len = n // tiles
    kernels.reset_launch_counts()
    head = quantized_head(batch, affine)
    out = path_quantized(batch, head, tiles)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    read_launches(rows, "path_quantized", counts)
    expect_launched("path_quantized", counts, "fused_world_bounds",
                    "fused_voxel_head", "tile_sort",
                    "fused_sorted_voxel_reduce_quantized")

    # the generic path on the same words: exact integer sums and the same
    # f32 operations, so 1e-5 only allows for a differently rounded division
    ref = path_quantized(batch, head, tiles, fused=False)
    err_generic = assert_same_voxels("path_quantized", out, ref, 1e-5)
    del ref
    # f64 oracle from the head's own keys and residual words: cell +
    # (mean residual + 0.5) / 2**q leaves, per (tile, voxel), in order
    bmin, keys, qword = head
    nv = int(out.count.item())
    q = u32_carrier(qword).cpu().numpy()
    group = tile_groups(u32_carrier(keys).cpu().numpy(), tile_len)
    qm = (1 << QBITS) - 1
    resid = np.stack([(q >> (2 * QBITS)) & qm, (q >> QBITS) & qm, q & qm],
                     axis=1)
    ukeys = np.unique(group) & 0xFFFFFFFF
    cells = np.stack([_compact10_np(ukeys >> a) for a in range(3)], axis=1)
    oracle = (cells + (group_means_f64(group, resid) + 0.5) / (1 << QBITS)) \
        * LEAF + bmin.cpu().numpy().astype(np.float64)
    err_oracle = max_dist(out.data[POS][:nv], oracle, "path_quantized")
    if not err_oracle < 1e-4:
        raise AssertionError(f"path_quantized: a centroid is {err_oracle} "
                             f"from the f64 oracle of its own words")
    del out

    # (ii) no precomputed words: keys and residuals made inside from the
    # f32 positions
    before = kernels.launch_counts()
    inside = path_quantized_internal(wbatch, bmin, tiles)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for c in ("tile_sort", "fused_sorted_voxel_reduce_quantized"):
        if after[c] - before[c] != 1:
            raise AssertionError(f"path_quantized (internal quantizer): "
                                 f"{after[c] - before[c]} launches of {c}")
    ref = path_quantized_internal(wbatch, bmin, tiles, fused=False)
    err_inside = assert_same_voxels("path_quantized (internal quantizer)",
                                    inside, ref, 1e-5)
    nv_inside = int(inside.count.item())
    del ref, inside

    ms, lo, hi = step_ms(lambda i: path_quantized(
        batch, quantized_head(batch, affine, (i % 7) * 1e-6), tiles))
    ms2, lo2, hi2 = step_ms(lambda i: path_quantized_internal(
        wbatch, bmin, tiles))
    print(json.dumps({
        "phase": "path_quantized", "points": n, "tiles": tiles, "voxels": nv,
        "launches": counts, "max_err_vs_generic_path": err_generic,
        "max_err_vs_f64_oracle": err_oracle, "step_ms": ms,
        "step_ms_min": lo, "step_ms_max": hi, "repeats": 7,
        "mpoints_per_s": n / ms / 1e3,
        "internal_quantizer": {
            "voxels": nv_inside, "max_err_vs_generic_path": err_inside,
            "step_ms": ms2, "step_ms_min": lo2, "step_ms_max": hi2},
        "card": smi}), flush=True)


def _compact10_np(v: np.ndarray) -> np.ndarray:
    """Every third bit of ``v``, from bit 0, gathered into 10 bits."""
    v = v & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    return (v | (v >> 16)) & 0x3FF


def phase_path_exact_f32(batch: PointBatch, affine, tiles: int, rows: list,
                         smi: str) -> None:
    """Path C at the full batch, checked, counted, timed."""
    n = batch.capacity
    tile_len = n // tiles
    kernels.reset_launch_counts()
    head = exact_f32_head(batch, affine)
    out = path_exact_f32(batch, head, tiles)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    read_launches(rows, "path_exact_f32", counts)
    expect_launched("path_exact_f32", counts, "fused_world_bounds",
                    "fused_decode_transform_key", "tile_sort",
                    "fused_sorted_voxel_reduce_exact_f32")

    # the generic path sums f32 positions in f32 by atomics, the kernel in
    # f64: 1e-4 of coordinates ~150, the bound the JAX package's own tests
    # hold these two paths to
    ref = path_exact_f32(batch, head, tiles, fused=False)
    err_generic = assert_same_voxels("path_exact_f32", out, ref, 1e-4)
    del ref
    # f64 oracle: mean of the head's f32 world positions per (tile, voxel)
    bmin, world, keys = head
    nv = int(out.count.item())
    group = tile_groups(u32_carrier(keys).cpu().numpy(), tile_len)
    err_oracle = max_dist(out.data[POS][:nv],
                          group_means_f64(group, world.cpu().numpy()),
                          "path_exact_f32")
    if not err_oracle < 1e-4:
        raise AssertionError(f"path_exact_f32: a centroid is {err_oracle} "
                             f"from the f64 oracle")
    del out

    # the same form without precomputed keys: the keys are made inside
    before = kernels.launch_counts()
    inside = path_exact_f32(batch, head, tiles, precomputed=False)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for c in ("tile_sort", "fused_sorted_voxel_reduce_exact_f32"):
        if after[c] - before[c] != 1:
            raise AssertionError(f"path_exact_f32 (keys made inside): "
                                 f"{after[c] - before[c]} launches of {c}")
    ref = path_exact_f32(batch, head, tiles, fused=False, precomputed=False)
    err_inside = assert_same_voxels("path_exact_f32 (keys made inside)",
                                    inside, ref, 1e-4)
    del ref, inside

    ms, lo, hi = step_ms(lambda i: path_exact_f32(
        batch, exact_f32_head(batch, affine, (i % 7) * 1e-6), tiles))
    print(json.dumps({
        "phase": "path_exact_f32", "points": n, "tiles": tiles, "voxels": nv,
        "launches": counts, "max_err_vs_generic_path": err_generic,
        "max_err_vs_f64_oracle": err_oracle,
        "max_err_keys_made_inside_vs_generic_path": err_inside,
        "step_ms": ms, "step_ms_min": lo, "step_ms_max": hi, "repeats": 7,
        "mpoints_per_s": n / ms / 1e3, "card": smi}), flush=True)


def gpu_profile(step, steps: int = 5, warm: bool = True) -> dict:
    """Where ``steps`` steady calls of ``step(i)`` spend GPU time
    (``torch.profiler``): per step, the traced wall time, the device busy
    time (sum of kernel times), the hand kernels' share, the device
    launches, and the top kernels by name.  ``warm``: one call of
    ``step(0)`` first, outside the trace."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ours = ("world_bounds", "voxel_head", "decode_transform_key",
            "tile_sort", "voxel_reduce", "compact_write", "pt_zero_tail",
            "window_fit")
    by_name = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name.setdefault(e.name, [0.0, 0])
            by_name[e.name][0] += e.device_time / 1e3 / steps
            by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]
    return {
        "steps": steps, "traced_wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": sum(v[0] for v in by_name.values()),
        "hand_kernels_ms_per_step": sum(
            v[0] for k, v in by_name.items() if any(o in k for o in ours)),
        "device_launches_per_step": sum(
            v[1] for v in by_name.values()) / steps,
        "top": [{"name": k[:60], "ms_per_step": v[0],
                 "calls_per_step": v[1] / steps} for k, v in top]}


def phase_profile(path: str, step, steps: int = 5) -> None:
    """One ``profile`` line: :func:`gpu_profile` of ``path``."""
    print(json.dumps({"phase": "profile", "path": path,
                      **gpu_profile(step, steps)}), flush=True)


def call_split(fn, calls: int = 5) -> list:
    """The device operations that one ``fn()`` call issues
    (``torch.profiler`` over ``calls`` warm calls): name, launches per call
    and device ms per call, in the order of first issue."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            op = ops.setdefault(e.name, [0, 0.0])
            op[0] += 1
            op[1] += e.device_time / 1e3
    return [{"name": k[:60], "per_call": v[0] / calls,
             "ms_per_call": v[1] / calls} for k, v in ops.items()]


def phase_call_split(batch: PointBatch, affine, tiles: int, smi: str
                     ) -> None:
    """One ``call_split`` line: the device operations of one K1 call (the
    main path's points and parameters), one K3 call (the exact-local form
    on the main path's tile-sorted streams) and one K5 call (the
    ``kernels`` row's columns and mask), at the timed shapes."""
    n = batch.capacity
    tile_len = n // tiles
    bmin, keys, rword, local_affine = pipeline_head(batch, affine)
    s = kernels.tile_sort([u32_bits(keys), u32_bits(_pack_word(batch)),
                           u32_bits(rword)], tile_len, num_keys=2)
    rargs = (s[0], s[1], s[2], bmin, LEAF, _MODE_BITS, _FIELDS, 10, 1.0,
             tile_len, "floor")
    gen = torch.Generator(device=batch.device).manual_seed(11)
    keep = torch.rand(n, device=batch.device, generator=gen) < 0.9
    ccols = [batch.data[LOCAL], batch.data[INT], batch.data[CLS]]
    k1 = call_split(lambda: kernels.fused_world_bounds(
        batch.data[LOCAL], *affine))
    k3 = call_split(lambda: vr.fused_sorted_voxel_reduce_rows(
        *rargs, local_affine=local_affine))
    k5 = call_split(lambda: ck.blockwise_compact(ccols, keep))
    # K1: the one launch; K3: the status memset, the reduce, the zero tail,
    # and the `cat` that assembles its parameter vector; K5: the memset,
    # the write, the tail
    for name, ops, most in (("K1", k1, 1), ("K3", k3, 4), ("K5", k5, 3)):
        if sum(op["per_call"] for op in ops) > most:
            raise AssertionError(f"one {name} call issued {ops}")
    print(json.dumps({"phase": "call_split", "points": n, "tiles": tiles,
                      "fused_world_bounds": k1,
                      "fused_sorted_voxel_reduce": k3,
                      "blockwise_compact": k5, "card": smi}), flush=True)


def phase_path_concat_convert(smi: str) -> None:
    """The merge of tiles before a voxel step: eight padded batches
    (4 194 304 rows) concatenated (K5 once), converted to
    ``CONVERT_SCHEMA`` and encoded back from f64 world positions.  Gates:
    the count; every column of the three results ``[:count]`` equal to the
    same calls on the CPU; the encoded locals equal to the merged ones;
    zero rows past the count.  Then timed (CUDA events), with the device
    busy time beside it."""
    batches = concat_batches()
    want_count = sum(int(b.count.item()) for b in batches)
    kernels.reset_launch_counts()
    merged, conv, back = path_concat_convert(batches)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if counts["blockwise_compact"] != 1:
        raise AssertionError(f"path_concat_convert: "
                             f"{counts['blockwise_compact']} K5 launches, "
                             f"expected 1")
    nc = int(merged.count.item())
    if nc != want_count or int(conv.count.item()) != nc:
        raise AssertionError(f"path_concat_convert: {nc} rows, the inputs "
                             f"hold {want_count}")
    cpu = path_concat_convert(batches_on(batches, "cpu"))
    if int(cpu[0].count) != nc:
        raise AssertionError("path_concat_convert: the CPU run counts "
                             f"{int(cpu[0].count)} rows")
    for what, got, ref in (("merged", merged, cpu[0]),
                           ("converted", conv, cpu[1])):
        if list(got.data) != list(ref.data):
            raise AssertionError(f"path_concat_convert: {what} columns "
                                 f"{list(got.data)}")
        for name, col in got.data.items():
            if col.dtype != ref.data[name].dtype or not torch.equal(
                    col[:nc].cpu(), ref.data[name][:nc]):
                raise AssertionError(f"path_concat_convert: {what} column "
                                     f"{name} differs from the CPU run's")
    if not torch.equal(back[:nc].cpu(), cpu[2][:nc]):
        raise AssertionError("path_concat_convert: the encoded locals "
                             "differ from the CPU run's")
    if not torch.equal(back[:nc], merged.data[LOCAL][:nc]):
        raise AssertionError("path_concat_convert: decode -> encode did not "
                             "give the locals back")
    if any(bool((c[nc:] != 0).any()) for c in merged.data.values()) \
            or bool((conv.data[att.GPS_TIME.name] != 0).any()):
        raise AssertionError("path_concat_convert: rows past the count or "
                             "the filled column are not zero")
    del cpu, merged, conv, back
    ms, lo, hi = step_ms(lambda i: path_concat_convert(batches), reps=7)
    prof = gpu_profile(lambda i: path_concat_convert(batches), steps=3)
    print(json.dumps({
        "phase": "path_concat_convert", "batches": CONCAT_BATCHES,
        "capacity": CONCAT_CAPACITY * CONCAT_BATCHES, "rows": nc,
        "launches": counts, "equal_to_cpu": True, "round_trip_exact": True,
        "step_ms": ms, "step_ms_min": lo, "step_ms_max": hi, "repeats": 7,
        "mrows_per_s": CONCAT_CAPACITY * CONCAT_BATCHES / ms / 1e3,
        "device_busy_ms": prof["device_busy_ms_per_step"],
        "hand_kernels_ms": prof["hand_kernels_ms_per_step"],
        "device_launches": prof["device_launches_per_step"],
        "top": prof["top"][:6], "card": smi}), flush=True)


def phase_path_normals(pos: np.ndarray, rows: list, smi: str) -> None:
    """Morton-window normals of the 2 097 152-point surface from a host
    buffer: gated against the analytic normal and against the same call on
    K6's plain version, counted, timed."""
    n = pos.shape[0]
    buf = positions_buffer(pos)
    kernels.reset_launch_counts()
    nrm, curv = path_normals(buf)
    counts = kernels.launch_counts()      # the result is on the host: synced
    read_launches(rows, "path_normals", counts)
    if counts["window_fit_moments"] != 2:
        raise AssertionError(f"path_normals: {counts['window_fit_moments']} "
                             f"K6 launches, expected 2 (one per curve)")
    if nrm.shape != (n, 3) or not (np.isfinite(nrm).all()
                                   and np.isfinite(curv).all()):
        raise AssertionError("path_normals: bad shape or non-finite values")
    frac6 = within_degrees(nrm, pos)
    if not frac6 >= 0.99:
        raise AssertionError(f"path_normals: {frac6} of normals within 6° "
                             f"of the analytic surface")
    # the whole path once more with K6's plain version in its place
    before = kernels.launch_counts()["window_fit_moments"]
    normals_mod._PLAIN_WINDOW_FIT = True
    try:
        pnrm, pcurv = path_normals(buf)
    finally:
        normals_mod._PLAIN_WINDOW_FIT = False
    if kernels.launch_counts()["window_fit_moments"] != before:
        raise AssertionError("path_normals: the plain run launched K6")
    if not (np.array_equal(nrm, pnrm) and np.array_equal(curv, pcurv)):
        raise AssertionError(
            f"path_normals: normals on K6 differ from those on its plain "
            f"version by {np.abs(nrm - pnrm).max()}")
    ms, lo, hi = step_ms(lambda i: path_normals(buf), warmup=1, reps=5)
    prof = gpu_profile(lambda i: path_normals(buf), steps=2)
    print(json.dumps({
        "phase": "path_normals", "points": n, "k": NORMALS_K,
        "window": NORMALS_WINDOW, "launches": counts,
        "frac_within_6deg": frac6, "equal_to_plain_k6": True,
        "step_ms": ms, "step_ms_min": lo, "step_ms_max": hi, "repeats": 5,
        "mpoints_per_s": n / ms / 1e3,
        "device_busy_ms": prof["device_busy_ms_per_step"],
        "k6_ms": sum(t["ms_per_step"] for t in prof["top"]
                     if "window_fit" in t["name"]),
        "device_launches": prof["device_launches_per_step"],
        "card": smi}), flush=True)


def phase_path_icp(dev: torch.device, rows: list, smi: str) -> tuple:
    """Morton-correspondence ICP at 1 048 576 points, point-to-point and
    point-to-plane: pose recovered, K6 launched only for the target
    normals (its row at this shape reads the point-to-plane run's
    launches), then three runs timed (host clock to a synchronise).
    Returns the device tensors (source, target)."""
    source, target = icp_pair()
    src = torch.from_numpy(source).to(dev)
    tgt = torch.from_numpy(target).to(dev)
    out = {"phase": "path_icp", "points": ICP_N, "iterations": ICP_ITERS,
           "card": smi}
    for p2pl in (False, True):
        name = "point_to_plane" if p2pl else "point_to_point"
        kernels.reset_launch_counts()
        res = path_icp(src, tgt, p2pl)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        k6 = counts["window_fit_moments"]
        if k6 != (2 if p2pl else 0):
            raise AssertionError(f"path_icp ({name}): {k6} K6 launches")
        if p2pl:
            read_launches(rows, "path_icp", counts)
        resid = icp_residual(res, source, target)
        if not resid < 0.02:
            raise AssertionError(f"path_icp ({name}): mean residual {resid} "
                                 f"m after the estimated pose")
        if p2pl:
            # K6 at this path's shape (1 048 576 target rows, k = 10,
            # w = 64): the same run with its plain version in its place
            # gives the same pose bit for bit
            normals_mod._PLAIN_WINDOW_FIT = True
            try:
                plain = path_icp(src, tgt, True)
            finally:
                normals_mod._PLAIN_WINDOW_FIT = False
            if kernels.launch_counts()["window_fit_moments"] != k6:
                raise AssertionError("path_icp: the plain run launched K6")
            if not all(torch.equal(getattr(res, f), getattr(plain, f))
                       for f in ("rotation", "translation", "rmse",
                                 "num_inliers")):
                raise AssertionError(
                    "path_icp: the pose on K6 differs from the pose on its "
                    "plain version")
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = path_icp(src, tgt, p2pl)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        sec = float(np.median(runs))
        out[name] = {"mean_abs_residual_m": resid, "launches": counts,
                     "equal_to_plain_k6": True if p2pl else None,
                     "num_inliers": int(res.num_inliers.item()),
                     "seconds": sec, "seconds_min": min(runs),
                     "seconds_max": max(runs),
                     "mcorrespondences_per_s": ICP_N * ICP_ITERS / sec / 1e6}
    print(json.dumps(out), flush=True)
    return src, tgt


def phase_path_registration(smi: str) -> None:
    """``RegistrationPipeline`` over four scans 0.1 m apart: keyframe
    spacing within 0.02 m of the truth, K5 launched by the voxel
    downsampling and equal to its plain version on one scan's own inputs,
    K8 launched by the ICP; then the keyframes knocked off their odometry
    poses and brought back by the pose graph, dense (``optimize()``) and
    CG: the cost falls by 1e-12 or more without rising, the poses return
    within 1e-6.  The whole run timed."""
    scans = registration_scans()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pipe, odometry, knocked, cost0, costs = path_registration(scans)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expect_launched("path_registration", counts, "blockwise_compact",
                    "icp_correspond_accumulate", "icp_solve_update")
    kept = held_compaction(scans[0])
    if len(pipe.keyframes) != REG_SCANS:
        raise AssertionError(f"path_registration: {len(pipe.keyframes)} "
                             f"keyframes")
    err = trajectory_error(odometry[1])
    if not err < 0.02:
        raise AssertionError(f"path_registration: keyframe spacing off by "
                             f"{err} m")
    dense_err = pose_error(np.stack([kf.rotation for kf in pipe.keyframes]),
                           pipe.trajectory(), odometry)
    cg_graph, cg_costs = optimize_pose_graph(knocked, solver="cg")
    cg_costs = cg_costs.cpu().numpy()
    cg_err = pose_error(cg_graph.rotations.cpu().numpy(),
                        cg_graph.translations.cpu().numpy(), odometry)
    for solver, curve, perr in (("dense", costs, dense_err),
                                ("cg", cg_costs, cg_err)):
        # non-increasing up to the rounding of an f64 sum near zero
        if not (np.all(np.diff(np.concatenate([[cost0], curve])) <= 1e-12)
                and curve[-1] <= 1e-12 * cost0):
            raise AssertionError(f"path_registration ({solver}): cost "
                                 f"{cost0} -> {curve}")
        if not perr < 1e-6:
            raise AssertionError(f"path_registration ({solver}): poses "
                                 f"{perr} from the odometry")
    print(json.dumps({
        "phase": "path_registration", "scans": REG_SCANS,
        "points_per_scan": REG_N, "voxel_size": REG_VOXEL,
        "points_per_keyframe": [len(k.points) for k in pipe.keyframes],
        "max_spacing_error_m": err, "k5_equal_to_plain": True,
        "k5_kept_rows_scan0": kept, "knocked_cost": cost0,
        "costs": [float(c) for c in costs],
        "cg_costs": [float(c) for c in cg_costs],
        "max_pose_error": {"dense": dense_err, "cg": cg_err},
        "launches": counts, "seconds": sec,
        "cg_ms_per_iteration": cg_iteration_ms(pipe.graph()), "card": smi}),
        flush=True)


def phase_path_normals_exact(smi: str) -> None:
    """The port of ``benches/normals_bench.py --exact``: exact normals of
    the bench's 1 048 576-point surface (k = 12) through
    ``compute_normals(method="exact")`` from a host buffer.  Gated before
    any time counts (:func:`gate_normals_exact`, :func:`check_certified`,
    :func:`cross_check_exact`), then timed (median of 2 after the warm
    call that the gates read), with the scan's block visits and host
    syncs, peak memory and the device's busy share of one traced call."""
    if importlib.util.find_spec("scipy") is None:
        raise RuntimeError("path_normals_exact: the kd-tree oracle needs "
                           "scipy")
    pos = normals_surface(EXACT_N)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    nrm, curv = exact_normals(pos)
    warm_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    out = {"phase": "path_normals_exact", "points": EXACT_N, "k": EXACT_K,
           "launches": counts}
    gate_s = {}
    for name, gate in (
            ("oracle", lambda: gate_normals_exact(pos, nrm, curv)),
            ("certified", lambda: {"certified": check_certified(pos)}),
            ("card_vs_cpu", lambda: {"card_vs_cpu": cross_check_exact()})):
        t0 = time.perf_counter()
        out.update(gate())
        gate_s[name] = time.perf_counter() - t0
    normals_mod.SCAN_COUNTS.update(dict.fromkeys(normals_mod.SCAN_COUNTS, 0))
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        exact_normals(pos)
        runs.append(time.perf_counter() - t0)
    scan = {k: v / 2 for k, v in normals_mod.SCAN_COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    # the device's busy share over one query slice of the same call
    p = torch.from_numpy(pos).cuda()
    ones = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)

    def one_slice(i):
        with fp32_matmul():
            normals_mod._normals_scan_exact(
                p, ones, EXACT_K, queries=p[:normals_mod._EXACT_SLICE])
    prof = gpu_profile(one_slice, steps=1, warm=False)
    sec = float(np.median(runs))
    print(json.dumps({
        **out, "gate_seconds": gate_s, "warm_seconds": warm_s,
        "seconds": sec, "seconds_runs": runs,
        "mpoints_per_s": EXACT_N / sec / 1e6, "query_tiles": scan["tiles"],
        "tiles_summing_whole_blocks": scan["dense_tiles"],
        "block_visits_per_tile": scan["visits"] / scan["tiles"],
        "block_visits_max": normals_mod.SCAN_COUNTS["max_visits"],
        "host_syncs": scan["host_syncs"], "peak_memory_mb": peak / 2**20,
        "device_busy_share_one_slice": prof["device_busy_ms_per_step"]
        / prof["traced_wall_ms_per_step"],
        "traced_ms_one_slice": prof["traced_wall_ms_per_step"],
        "device_launches_one_slice": prof["device_launches_per_step"],
        "top": prof["top"][:6], "card": smi}), flush=True)


def phase_path_pose_graph(smi: str) -> None:
    """The port of ``benches/pose_graph_bench.py``: the circle graph solved
    dense at 256 / 1 024 / 2 048 poses and by CG at 1 024 / 5 000 /
    10 000 / 20 000 (:func:`gate_pose_graph`): ms per Gauss-Newton
    iteration, ATE and edges per size."""
    t0 = time.perf_counter()
    runs, gap = gate_pose_graph()
    print(json.dumps({"phase": "path_pose_graph", "iterations": POSE_ITERS,
                      **POSE_CG_KW, "runs": runs,
                      "dense_cg_max_diff_m": gap,
                      "seconds": time.perf_counter() - t0, "card": smi}),
          flush=True)


def phase_path_trajectory(rows: list, smi: str) -> None:
    """``RegistrationPipeline`` over a closed loop of ``TRAJ_SCANS`` scans
    of ``TRAJ_N`` points (:func:`trajectory_scan`), the loop closed by ICP,
    then the pose graph: gated (:func:`gate_trajectory`), K5 held against
    its plain version on one scan's own inputs and timed as a row; wall
    seconds of the pipeline (the scans' draws left out), its split per
    scan, and the device's busy share over two scans traced (one ICP)."""
    poses = trajectory_poses()
    draw_s = []

    def scans():
        for i in range(TRAJ_SCANS):
            t0 = time.perf_counter()
            scan = trajectory_scan(i, poses)
            draw_s.append(time.perf_counter() - t0)
            yield scan
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pipe, odometry, costs, sec = path_trajectory(scans())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - sum(draw_s)
    counts = kernels.launch_counts()
    expect_launched("path_trajectory", counts, "blockwise_compact",
                    "icp_correspond_accumulate", "icp_solve_update")
    gate = gate_trajectory(pipe, poses, TRAJ_SCANS)
    scan0 = trajectory_scan(0, poses)
    cols, keep, _ = capture_compaction(scan0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=keep.device)
    compaction_row(rows, cols, keep, "blockwise_compact_trajectory",
                   "path_trajectory", flush)
    read_launches(rows, "path_trajectory", counts)
    two = [scan0, trajectory_scan(1, poses)]

    def prefix(i):
        p2 = RegistrationPipeline(voxel_size=REG_VOXEL,
                                  keyframe_distance=0.05)
        for sc in two:
            p2.add_scan(sc)
    prof = gpu_profile(prefix, steps=1, warm=False)
    icp_s = sec["icp"][:TRAJ_SCANS - 1]
    points = TRAJ_SCANS * TRAJ_N
    print(json.dumps({
        "phase": "path_trajectory", "scans": TRAJ_SCANS,
        "points_per_scan": TRAJ_N, "voxel_size": REG_VOXEL,
        "keyframe_points_mean": float(np.mean([len(k.points)
                                               for k in pipe.keyframes])),
        "odometry_errors": pose_errors(*odometry, poses), **gate,
        "costs": [float(c) for c in costs], "k5_equal_to_plain": True,
        "launches": counts,
        "k5_launches_per_scan": counts["blockwise_compact"] / TRAJ_SCANS,
        "seconds": wall, "mpoints_per_s": points / wall / 1e6,
        "downsample_ms_per_scan": float(np.mean(
            sec["downsample"][:TRAJ_SCANS])) * 1e3,
        "icp_ms_per_scan": float(np.mean(icp_s)) * 1e3,
        "loop_closure_icp_ms": sec["icp"][-1] * 1e3,
        "pose_graph_ms": (sec["pose_graph"] - sec["icp"][-1]) * 1e3,
        "draw_seconds": sum(draw_s),
        "device_busy_share_2_scans": prof["device_busy_ms_per_step"]
        / prof["traced_wall_ms_per_step"],
        "traced_ms_2_scans": prof["traced_wall_ms_per_step"],
        "top": prof["top"][:6], "card": smi}), flush=True)


def counted_fold(path, device=None):
    """One default fold with the launch counts and the fold's host syncs
    set to 0 just before and read just after; the first K4 call's streams
    and the merge's first key compaction are captured on the way.  Returns
    ``(result, launches, host syncs, captured)``."""
    captured = {}

    def capture_sort(streams, tile_len, num_keys=1):
        captured.setdefault("tile_sort", ([s.clone() for s in streams],
                                          tile_len, num_keys))
        return ts.tile_sort(streams, tile_len, num_keys=num_keys)

    def capture_compact(cols, keep):
        captured.setdefault("compact", ([c.clone() for c in cols],
                                        keep.clone()))
        return compact_columns(cols, keep)

    voxel_mod.tile_sort = capture_sort
    merge_mod.compact_columns = capture_compact
    try:
        kernels.reset_launch_counts()
        streaming.HOST_SYNCS["streaming_voxel_downsample"] = 0
        out = file_fold(path, device=device)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        syncs = streaming.HOST_SYNCS["streaming_voxel_downsample"]
    finally:
        voxel_mod.tile_sort = ts.tile_sort
        merge_mod.compact_columns = compact_columns
    return out, counts, syncs, captured


def file_to_map_rows(rows: list, captured: dict,
                     path: str = "path_file_to_map") -> None:
    """K4 and K5 held against their plain versions on the inputs a fold
    gave them, timed, and added as rows of ``path``'s run."""
    tag = path.removeprefix("path_")
    dev = captured["compact"][1].device
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    tile_sort_row(rows, *captured["tile_sort"], f"tile_sort_{tag}", path,
                  flush)
    compaction_row(rows, *captured["compact"], f"blockwise_compact_{tag}",
                   path, flush)


def tile_sort_row(rows: list, streams: list, tile_len: int, num_keys: int,
                  name: str, path: str, flush: torch.Tensor) -> None:
    """K4 held against its plain version on inputs ``path`` gave it, timed,
    and added as the row ``name`` of ``path``'s run; the library call is
    ``torch.sort`` of the packed key with a gather of the other streams."""
    n = streams[0].shape[0]
    tiles = n // tile_len
    _, dkey = check_tile_sort(streams, tile_len, num_keys)
    packed = ((u32_carrier(streams[0]) << 32)
              | u32_carrier(streams[1])).reshape(tiles, tile_len)
    rest = [s.reshape(tiles, tile_len) for s in streams[2:]]

    def library_sort():
        srt = torch.sort(packed, dim=1)
        return srt.values, [r.gather(1, srt.indices) for r in rest]

    stages = (tile_len.bit_length() - 1) * tile_len.bit_length() // 2
    k = len(streams)
    add_row(rows, name, _CSRC + "tile_sort.cu",
            _TPU + "tile_sort_kernel.py:132", dkey,
            gpu_ms(lambda: kernels.tile_sort(streams, tile_len,
                                             num_keys=num_keys), flush),
            gpu_ms(lambda: ts.tile_sort_plain(streams, tile_len,
                                              num_keys=num_keys), flush,
                   reps=5),
            # 4 B read + 4 B written per stream and row; per
            # compare-exchange 4 compares of the two key words and 2 moves
            # a stream
            8.0 * k * n, (4.0 + 2 * k) * stages * (n // 2),
            library_ms=gpu_ms(library_sort, flush, reps=5),
            path=path, counter="tile_sort")


def compaction_row(rows: list, cols: list, keep: torch.Tensor, name: str,
                   path: str, flush: torch.Tensor) -> None:
    """K5 held against its plain version on inputs ``path`` gave it, timed,
    and added as the row ``name`` of ``path``'s run; the library call is
    boolean-mask indexing of each column."""
    m = keep.shape[0]
    kept = hold_compaction(cols, keep, f"{path}'s inputs")
    row_bytes = sum(c.numel() // m * c.element_size() for c in cols)
    add_row(rows, name, _CSRC + "compact.cu",
            _TPU + "compact_kernel.py:135", 0.0,
            gpu_ms(lambda: ck.blockwise_compact(cols, keep), flush),
            gpu_ms(lambda: ck.blockwise_compact_plain(cols, keep), flush,
                   reps=5),
            # the mask and every row read once, every output row written
            # once; a ballot, a popcount and a few adds per row, one move
            # per 4 bytes of a kept row
            m + 2.0 * row_bytes * m, 12.0 * m + row_bytes / 4.0 * kept,
            library_ms=gpu_ms(lambda: [c[keep] for c in cols], flush,
                              reps=5),
            path=path, counter="blockwise_compact")


def hold_compaction(cols: list, keep: torch.Tensor, what: str) -> int:
    """K5 against its plain version on ``cols`` / ``keep``; raises unless
    they agree.  Returns the kept count."""
    got, gcount = ck.blockwise_compact(cols, keep)
    want, wcount = ck.blockwise_compact_plain(cols, keep)
    torch.cuda.synchronize()
    kept = int(gcount.item())
    if kept != int(wcount.item()) or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"blockwise_compact on {what} differs from "
                             f"its plain version")
    return kept


def timed_folds(path, device, points: int, reps: int = 2) -> dict:
    """The fold as a caller sees it, ingest included (median of ``reps``
    runs, each ending in the read of the voxel count), then the device's
    busy time inside one more fold (``torch.profiler``, copies included)."""
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        int(file_fold(path, device=device).count.item())
        runs.append(time.perf_counter() - t0)
    prof = gpu_profile(lambda i: file_fold(path, device=device).count.item(),
                       steps=1)
    fold_s = float(np.median(runs))
    return {"fold_s": fold_s, "fold_s_runs": runs, "repeats": reps,
            "mpoints_per_s": points / fold_s / 1e6,
            "traced_fold_s": prof["traced_wall_ms_per_step"] / 1e3,
            "device_busy_s": prof["device_busy_ms_per_step"] / 1e3,
            "device_busy_share": prof["device_busy_ms_per_step"]
            / prof["traced_wall_ms_per_step"],
            "device_launches": prof["device_launches_per_step"],
            "top": prof["top"][:6]}


def phase_path_file_to_map(rows: list, smi: str, device=None) -> None:
    """The port of ``benches/end_to_end_bench.py``: a survey written as LAS
    (FILE_LAS_POINTS) and as LAZ (FILE_LAZ_POINTS, beside the same points
    as LAS) by the package's writer, each folded to a voxel map on the
    card.  The LAS fold is gated (``gate_file_to_map``) and the LAZ fold
    must equal the LAS fold of the same points bit for bit, before any time
    counts; K4 and K5 must launch on the path."""
    dev = resolve_device(device)
    work = Path(__file__).resolve().parent / FILE_DIR
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    try:
        las = work / "survey.las"
        t0 = time.perf_counter()
        write_all(make_survey(FILE_LAS_POINTS), las)
        write_s = time.perf_counter() - t0
        gate = gate_file_to_map(las, dev)
        out, counts, syncs, captured = counted_fold(las, dev)
        file_to_map_rows(rows, captured)
        del captured
        read_launches(rows, "path_file_to_map", counts)
        report(las, FILE_LAS_POINTS, dev, smi, {
            "file": "las", "write_s": write_s, **gate}, out, counts, syncs)

        small = make_survey(FILE_LAZ_POINTS, seed=12)
        las2, laz = work / "survey_small.las", work / "survey_small.laz"
        write_all(small, las2)
        t0 = time.perf_counter()
        write_all(small, laz)
        write_s = time.perf_counter() - t0
        del small
        out, counts, syncs, _ = counted_fold(laz, dev)
        expect_launched("path_file_to_map (laz)", counts, "tile_sort",
                        "blockwise_compact")
        compare_folds("the LAZ fold against the LAS fold of its points",
                      file_fold(laz, dev, with_aux=True),
                      file_fold(las2, dev, with_aux=True))
        report(laz, FILE_LAZ_POINTS, dev, smi, {
            "file": "laz", "write_s": write_s, "voxels":
            int(out.count.item()), "equal_to_las_fold": True}, out, counts,
            syncs)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def report(path, points: int, dev, smi: str, head: dict, out, counts,
           syncs: int) -> None:
    """One ``path_file_to_map`` line: host read, upload, the timed folds
    and the counted one's launches and host syncs."""
    chunks = -(-points // FILE_CHUNK)
    read_s = host_read_s(path)
    folds = timed_folds(path, dev, points)
    print(json.dumps({
        "phase": "path_file_to_map", **head, "points": points,
        "bytes": path.stat().st_size, "chunks": chunks,
        "chunk": FILE_CHUNK, "tile": FILE_TILE, "leaf": LEAF,
        "host_read_s": read_s, "host_read_mpoints_per_s": points / read_s
        / 1e6, "upload_ms_per_chunk": upload_ms(path, dev),
        **folds, "launches": counts,
        "tile_sort_per_chunk": counts["tile_sort"] / chunks,
        "blockwise_compact_per_chunk": counts["blockwise_compact"] / chunks,
        "device_ms_per_chunk": folds["device_busy_s"] * 1e3 / chunks,
        "fold_host_syncs": syncs, "voxels_counted_run": int(out.count.item()),
        "card": smi}), flush=True)


# ---- the format paths: 3D Tiles .pnts and ASCII --------------------------------

def formats_survey(n: int = FORMATS_N, seed: int = 11) -> HostPointBuffer:
    """:func:`make_survey`'s scene with an 8-bit colour per point and the
    terrain's analytic unit normal."""
    base = make_survey(n, seed)
    pos = base.get(POS)
    rng = np.random.default_rng(seed + 100)
    grad = np.stack([0.08 * np.cos(pos[:, 0] * 0.02),
                     -0.051 * np.sin(pos[:, 1] * 0.017)], axis=1)
    nrm = np.concatenate([-grad, np.ones((n, 1))], axis=1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return HostPointBuffer.from_columns(FORMATS_SCHEMA, {
        POS: pos, INT: base.get(INT), CLS: base.get(CLS),
        att.COLOR_RGB.name: rng.integers(0, 256, (n, 3)).astype(np.uint8),
        att.NORMAL.name: nrm.astype(np.float32)})


def pnts_forms(buf: HostPointBuffer) -> dict:
    """The writer options of the three ``.pnts`` files: plain positions
    relative to the scene's centre, quantized positions, oct16p normals."""
    pos = buf.get(POS)
    centre = np.round((pos.min(0) + pos.max(0)) / 2.0, 3)
    return {"rtc": {"rtc_center": centre},
            "quantized": {"quantize_positions": True},
            "oct16p": {"compress_normals": True}}


def check_pnts(form: str, kw: dict, buf: HostPointBuffer,
               back: HostPointBuffer) -> dict:
    """A ``.pnts`` file read back against what was written: colours equal;
    positions equal to the writer's f32 arithmetic (``rtc``) or within half
    a quantization step and the f32 rounding (``quantized``); normals equal
    (f32) or equal to the oct16p round trip and within OCT16P_MAX_DEG."""
    what = f"path_formats (.pnts, {form})"
    if sorted(back.schema.names) != sorted((POS, att.COLOR_RGB.name,
                                           att.NORMAL.name)) \
            or len(back) != len(buf):
        raise AssertionError(f"{what}: read back {back.schema.names} x "
                             f"{len(back)}")
    if not np.array_equal(back.get(att.COLOR_RGB.name),
                          buf.get(att.COLOR_RGB.name)):
        raise AssertionError(f"{what}: colours differ")
    pos32 = buf.get(POS).astype(np.float32)
    got = back.get(POS)
    out = {}
    if "rtc_center" in kw:
        rtc = np.asarray(kw["rtc_center"], np.float64)
        want = ((pos32.astype(np.float64) - rtc).astype(np.float32)
                .astype(np.float64) + rtc).astype(np.float32)
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: positions differ from the "
                                 f"writer's f32 arithmetic")
        out["max_position_err_m"] = float(np.abs(
            got.astype(np.float64) - buf.get(POS)).max())
    elif kw.get("quantize_positions"):
        step = (pos32.max(0).astype(np.float64)
                - pos32.min(0).astype(np.float64)) / 65535.0
        err = np.abs(got.astype(np.float64) - pos32.astype(np.float64))
        limit = step / 2.0 + 2.0 * EPS32 * np.abs(pos32).max(0)
        if not (err <= limit).all():
            raise AssertionError(f"{what}: a position is {err.max()} m off, "
                                 f"beyond half a step {step / 2}")
        out.update(max_position_err_m=err.max(0).tolist(),
                   quantization_step_m=step.tolist())
    else:
        if not np.array_equal(got, pos32):
            raise AssertionError(f"{what}: positions differ")
    nrm = buf.get(att.NORMAL.name)
    if kw.get("compress_normals"):
        want = oct16p_decode(oct16p_encode(nrm.astype(np.float64)))
        cos = np.clip(np.sum(back.get(att.NORMAL.name).astype(np.float64)
                             * nrm, axis=1), -1.0, 1.0)
        deg = float(np.degrees(np.arccos(cos.min())))
        if not np.array_equal(back.get(att.NORMAL.name), want) \
                or not deg < OCT16P_MAX_DEG:
            raise AssertionError(f"{what}: normals off by {deg} degrees")
        out["max_normal_err_deg"] = deg
    elif not np.array_equal(back.get(att.NORMAL.name), nrm):
        raise AssertionError(f"{what}: normals differ")
    return out


def check_ascii(buf: HostPointBuffer, back: HostPointBuffer) -> float:
    """ASCII read back: Intensity, Classification and colours equal,
    positions within half of the writer's last printed digit (5 decimals).
    Returns the largest position error."""
    if len(back) != len(buf):
        raise AssertionError(f"path_formats (ascii): {len(back)} rows")
    for name in (INT, CLS, att.COLOR_RGB.name):
        if not np.array_equal(back.get(name).astype(np.int64),
                              buf.get(name).astype(np.int64)):
            raise AssertionError(f"path_formats (ascii): {name} differs")
    err = float(np.abs(back.get(POS) - buf.get(POS)).max())
    if not err <= 0.5e-5 + 1e-12 * np.abs(buf.get(POS)).max():
        raise AssertionError(f"path_formats (ascii): a position is {err} "
                             f"off")
    return err


def check_batch(what: str, batch: PointBatch, host: HostPointBuffer) -> None:
    """A batch read onto the device holds the host read's columns (64-bit
    columns narrowed as the batch's policy says)."""
    back = batch.to_host()
    for name in host.schema.names:
        want = host.get(name)
        got = back.get(name)
        if got.dtype.kind == "f":
            want = want.astype(batch.logical_dtype(name)).astype(got.dtype)
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: the batch's {name} differs from "
                                 f"the host read")


def tool_lines(main, argv: list) -> list:
    """Run a tool's ``main`` and return its standard output's lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{argv}: exit code {rc}")
    return out.getvalue().splitlines()


def check_info(path) -> int:
    """``info --detailed`` of ``path``: its min/max line of every scalar and
    vector attribute equals numpy's min/max of the file's column.  Returns
    the number of lines checked."""
    lines = tool_lines(info_tool.main, [str(path), "--detailed"])
    stats = lines[lines.index("Attribute statistics:") + 1:]
    with open_reader(path) as r:
        buf = r.read_all()
    want = []
    for m in buf.schema.members:
        if m.dtype.kind in ("bytes", "custom"):
            continue
        col = buf.get(m.name)
        want.append(f"  {m.name:32s} min={col.min(0).tolist()} "
                    f"max={col.max(0).tolist()}")
    if stats[:len(want)] != want:
        raise AssertionError(f"info --detailed {path}: {stats} != {want}")
    return len(want)


def gate_formats(work: Path, buf: HostPointBuffer, device=None) -> dict:
    """Write the scene as the three ``.pnts`` forms and a part of it as
    ASCII, read each back with the package's readers and with
    ``read_batch`` onto ``device``, convert (ASCII -> LAS -> ``.pnts``) and
    ``info --detailed`` the results; every check passed, returns the write
    and read seconds of each form and the paths written."""
    n = len(buf)
    out = {"forms": {}}
    for form, kw in pnts_forms(buf).items():
        path = work / f"scene_{form}.pnts"
        t0 = time.perf_counter()
        with PntsWriter(path, buf.schema, **kw) as w:
            w.write(buf)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = PntsReader(path).read_all()
        read_s = time.perf_counter() - t0
        res = check_pnts(form, kw, buf, back)
        check_batch(f"path_formats (.pnts, {form})",
                    read_batch(path, device=device), back)
        out["forms"][form] = {"bytes": path.stat().st_size, "write_s": write_s,
                              "write_mpoints_per_s": n / write_s / 1e6,
                              "read_s": read_s,
                              "read_mpoints_per_s": n / read_s / 1e6, **res}
        out.setdefault("paths", {})[form] = path
    m = min(FORMATS_ASCII_N, n)
    part = buf.slice(0, m)
    txt = work / "scene.txt"
    t0 = time.perf_counter()
    with AsciiWriter(txt, FORMATS_ASCII) as w:
        w.write(part)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with AsciiReader(txt, FORMATS_ASCII) as r:
        back = r.read_all()
    read_s = time.perf_counter() - t0
    err = check_ascii(part, back)
    check_batch("path_formats (ascii)",
                PointBatch.from_host(back, device=device), back)
    out["forms"]["ascii"] = {
        "points": m, "format": FORMATS_ASCII, "bytes": txt.stat().st_size,
        "write_s": write_s, "write_mpoints_per_s": m / write_s / 1e6,
        "read_s": read_s, "read_mpoints_per_s": m / read_s / 1e6,
        "max_position_err_m": err}
    las, pnts = work / "from_ascii.las", work / "from_las.pnts"
    tool_lines(convert_tool.main, [str(txt), str(las), "--ascii-format",
                                   FORMATS_ASCII])
    tool_lines(convert_tool.main, [str(las), str(pnts)])
    if len(read_all(las)) != m or len(read_all(pnts)) != m:
        raise AssertionError("path_formats: convert lost points")
    out["info_lines_checked"] = check_info(las) + check_info(pnts)
    return out


def phase_path_formats(rows: list, smi: str, device=None) -> None:
    """What a user does to turn a 3D Tiles or text export into a map: the
    survey of ``path_file_to_map`` (FORMATS_N points, colours and normals
    added) written as ``.pnts`` with ``rtc_center``, with quantized
    positions and with oct16p normals, and FORMATS_ASCII_N of its points as
    ASCII; each read back and onto the card and checked
    (:func:`gate_formats`), converted and described by the tools.  Then the
    plain ``.pnts`` file folded to a map by ``streaming_voxel_downsample``
    and gated against a one-shot voxelization as ``path_file_to_map`` is
    (its Intensity and Classification, which ``.pnts`` does not hold, read
    as zeros); K4 and K5 counted on the fold, held against their plain
    versions on its inputs, and the fold timed with ingest."""
    dev = resolve_device(device)
    work = Path(__file__).resolve().parent / FORMATS_DIR
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    try:
        t0 = time.perf_counter()
        scene = formats_survey()
        t1 = time.perf_counter()
        gate = gate_formats(work, scene, dev)
        path = gate.pop("paths")["rtc"]
        t2 = time.perf_counter()
        fold_gate = gate_file_to_map(path, dev)
        t3 = time.perf_counter()
        out, counts, syncs, captured = counted_fold(path, dev)
        file_to_map_rows(rows, captured, "path_formats")
        del captured
        read_launches(rows, "path_formats", counts)
        chunks = -(-FORMATS_N // FILE_CHUNK)
        folds = timed_folds(path, dev, FORMATS_N)
        print(json.dumps({
            "phase": "path_formats", "points": FORMATS_N, **gate,
            "fold_file": path.name, "fold": fold_gate, **folds,
            "launches": counts,
            "tile_sort_per_chunk": counts["tile_sort"] / chunks,
            "blockwise_compact_per_chunk":
                counts["blockwise_compact"] / chunks,
            "fold_host_syncs": syncs, "voxels_counted_run":
                int(out.count.item()),
            "scene_s": t1 - t0, "formats_gate_s": t2 - t1,
            "fold_gate_s": t3 - t2, "phase_s": time.perf_counter() - t0,
            "card": smi}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- RANSAC segmentation ---------------------------------------------------------

def plane_scene(n: int = SEG_PLANE_N, seed: int = 31):
    """An airborne tile: 80 % of the points on the ground plane z = 0.05 x
    - 0.03 y + 12 over a 200 m square, within 0.01 m of it along its
    normal; 20 % clutter (vegetation, roofs) 0.5-30 m above it; shuffled.
    Returns (f32 positions, the ground's mask)."""
    rng = np.random.default_rng(seed)
    k = n * 4 // 5
    xy = rng.uniform(-100.0, 100.0, (n, 2))
    z = 0.05 * xy[:, 0] - 0.03 * xy[:, 1] + 12.0
    z[k:] += rng.uniform(0.5, 30.0, n - k)
    pos = np.concatenate([xy, z[:, None]], axis=1)
    unit = np.asarray([-0.05, 0.03, 1.0]) / np.linalg.norm([-0.05, 0.03, 1])
    pos[:k] += rng.uniform(-0.01, 0.01, (k, 1)) * unit
    order = rng.permutation(n)
    return pos[order].astype(np.float32), order < k


def wire_scene(n: int = SEG_LINE_N, seed: int = 32):
    """A power line: 40 % of the points within 0.01 m a coordinate of a
    150 m straight span from (-75, -10, 15) to (75, 10, 20); 60 % clutter in
    the 150 x 40 x 30 m box around it; shuffled.  Returns (f32 positions,
    the wire's mask)."""
    rng = np.random.default_rng(seed)
    k = n * 2 // 5
    a, b = np.asarray([-75.0, -10.0, 15.0]), np.asarray([75.0, 10.0, 20.0])
    t = rng.uniform(0.0, 1.0, (k, 1))
    wire = a + t * (b - a) + rng.uniform(-0.01, 0.01, (k, 3))
    clutter = rng.uniform([-75.0, -20.0, 0.0], [75.0, 20.0, 30.0],
                          (n - k, 3))
    pos = np.concatenate([wire, clutter])
    order = rng.permutation(n)
    return pos[order].astype(np.float32), order < k


def f32_bound(pos: torch.Tensor, samples: torch.Tensor, k: int,
              dist: torch.Tensor) -> torch.Tensor:
    """(c, P) bound on how far the scorer's float32 distance of each point
    to each hypothesis can lie from the f64 one of the same inputs, by
    rounding analysis with a factor of 2 to spare (ε = EPS32, r = |p - s0|):
    a plane ε (32 r / sin θ + 8 (|p| + |s0|) + 8 d), θ the angle of its
    triangle at s0, since the edge vectors and their cross product round
    with the points' magnitude and ``p·n + d`` cancels; a line ε (32 r +
    8 d)."""
    s0 = samples[:, 0]
    r = torch.linalg.vector_norm(pos[None] - s0[:, None], dim=-1)
    if k == 3:
        u, v = samples[:, 1] - s0, samples[:, 2] - s0
        sin = (torch.linalg.vector_norm(torch.linalg.cross(u, v), dim=-1)
               / (torch.linalg.vector_norm(u, dim=-1)
                  * torch.linalg.vector_norm(v, dim=-1))).clamp_min(1e-300)
        size = (torch.linalg.vector_norm(pos, dim=-1)[None]
                + torch.linalg.vector_norm(s0, dim=-1)[:, None])
        return EPS32 * (32.0 * r / sin[:, None] + 8.0 * size + 8.0 * dist)
    return EPS32 * (32.0 * r + 8.0 * dist)


def recount(pos: torch.Tensor, mask: torch.Tensor, samples: torch.Tensor,
            k: int, threshold: float) -> dict:
    """The f64 recount of every hypothesis on the device: per hypothesis
    its inlier count, its points within :func:`f32_bound` of the threshold
    and its points within SEG_BAND x threshold, from f64 distances of the
    same f32 inputs."""
    pos64, s64 = pos.double(), samples.double()
    rows = 1 << 15
    out = {key: torch.zeros(samples.shape[0], dtype=torch.int64,
                            device=pos.device)
           for key in ("count", "near", "band")}
    for h in range(0, s64.shape[0], seg._HYPO_CHUNK):
        s = s64[h:h + seg._HYPO_CHUNK]
        for p in range(0, pos64.shape[0], rows):
            pp, m = pos64[p:p + rows], mask[None, p:p + rows]
            d = seg._hypothesis_distances(pp, s, k)
            off = (d - threshold).abs()
            sl = slice(h, h + s.shape[0])
            out["count"][sl] += ((d < threshold) & m).sum(1)
            out["near"][sl] += ((off <= f32_bound(pp, s, k, d)) & m).sum(1)
            out["band"][sl] += ((off <= SEG_BAND * threshold) & m).sum(1)
    return out


def check_counts(what: str, counts: torch.Tensor, ref: dict,
                 other: torch.Tensor = None) -> dict:
    """Each hypothesis's count equals the f64 recount's (or ``other``'s)
    but for its points within the f32 bound of the threshold; returns the
    readings, with how many hypotheses differ by more than their points
    within SEG_BAND x threshold."""
    want = ref["count"] if other is None else other
    diff = (counts - want).abs()
    if bool((diff > ref["near"]).any()):
        h = int((diff - ref["near"]).argmax().item())
        raise AssertionError(f"{what}: hypothesis {h} counts {int(counts[h])}"
                             f", against {int(want[h])} with "
                             f"{int(ref['near'][h])} points near the "
                             f"threshold")
    return {"hypotheses": int(counts.shape[0]),
            "max_count_diff": int(diff.max().item()),
            "points_near_threshold_f32": int(ref["near"].sum().item()),
            "points_in_band": int(ref["band"].sum().item()),
            "hypotheses_off_by_more_than_band":
                int((diff > ref["band"]).sum().item())}


def seg_hypotheses(batch: PointBatch, k: int, iters: int, seed: int):
    """The hypotheses the public call draws: ``_sample_indices`` over the
    first ``max(count, k)`` rows, iterations rounded up to 128s."""
    n = max(int(batch.count.item()), k)
    rounded = -(-iters // seg._HYPO_CHUNK) * seg._HYPO_CHUNK
    idx = seg._sample_indices(seed, rounded, n, k).to(batch.device)
    return batch.data[POS][idx]


def ransac(batch, k: int, iters: int, seed: int):
    fn = seg.ransac_plane_device if k == 3 else seg.ransac_line_device
    return fn(batch, SEG_THRESHOLD, iters, seed=seed)


def geometry(model) -> tuple:
    """A RANSAC model's plane coefficients or line points, not its count."""
    if isinstance(model, seg.Plane):
        return (model.a, model.b, model.c, model.d)
    return tuple(model.first) + tuple(model.second)


def gate_segmentation(pos: np.ndarray, own: np.ndarray, k: int, iters: int,
                      seed: int, device=None) -> dict:
    """The public call on a batch on ``device``, gated: every hypothesis's
    count and the winner's inlier set equal to their f64 recount but for
    points within the f32 bound of the threshold; the winner is the first
    maximum of those counts and holds 90 % of the scene's own points; a
    second call gives the same result."""
    what = f"path_segmentation ({'plane' if k == 3 else 'line'})"
    batch = PointBatch.from_host(positions_buffer(pos), device=device)
    model, inliers = ransac(batch, k, iters, seed)
    samples = seg_hypotheses(batch, k, iters, seed)
    mask = batch.valid_mask()
    with fp32_matmul():
        counts = seg._score_hypotheses(batch.data[POS], mask, samples, k,
                                       SEG_THRESHOLD)
    ref = recount(batch.data[POS], mask, samples, k, SEG_THRESHOLD)
    res = check_counts(what, counts, ref)
    best = int(counts.argmax().item())
    if model.ranking != int(counts[best]):
        raise AssertionError(f"{what}: the winner ranks {model.ranking}, "
                             f"the first maximum counts {int(counts[best])}")
    win = samples[best:best + 1].double()
    d = seg._hypothesis_distances(batch.data[POS].double(), win, k)
    near = ((d - SEG_THRESHOLD).abs() <= f32_bound(
        batch.data[POS].double(), win, k, d))[0]
    got = torch.zeros_like(mask)
    got[torch.from_numpy(inliers).to(mask.device)] = True
    differ = got != ((d[0] < SEG_THRESHOLD) & mask)
    if bool((differ & ~near).any()):
        raise AssertionError(f"{what}: the winner's inliers differ from "
                             f"their f64 recount off the threshold")
    held = float(own[inliers].sum() / own.sum())
    if not held >= 0.9:
        raise AssertionError(f"{what}: the winner holds {held} of the "
                             f"scene's own points")
    again = ransac(batch, k, iters, seed)
    if geometry(again[0]) != geometry(model) \
            or again[0].ranking != model.ranking \
            or not np.array_equal(again[1], inliers):
        raise AssertionError(f"{what}: a second call differs")
    return {"points": len(pos), "iterations": iters,
            "scored_hypotheses": int(samples.shape[0]), **res,
            "ranking": model.ranking, "share_of_own_points": held,
            "winner_inliers_differing_from_f64": int(differ.sum().item()),
            "same_on_second_call": True, "batch": batch}


def cross_check_cpu(pos: np.ndarray, k: int, iters: int, seed: int,
                    device) -> dict:
    """SEG_CROSS_N points on the card and on the CPU: the same hypotheses,
    counts equal but for points within the f32 bound of the threshold (of
    either result), and the same winner unless the two winners' counts lie
    within those points of each other, which is then printed."""
    what = f"path_segmentation ({'plane' if k == 3 else 'line'}, cpu)"
    host = positions_buffer(pos[:SEG_CROSS_N])
    on = {d: PointBatch.from_host(host, device=d) for d in (device, "cpu")}
    samples = {d: seg_hypotheses(b, k, iters, seed) for d, b in on.items()}
    if not torch.equal(samples[device].cpu(), samples["cpu"]):
        raise AssertionError(f"{what}: the hypotheses differ")
    counts = {}
    with fp32_matmul():
        for d, b in on.items():
            counts[d] = seg._score_hypotheses(b.data[POS], b.valid_mask(),
                                              samples[d], k,
                                              SEG_THRESHOLD).cpu()
    cpu = on["cpu"]
    ref = recount(cpu.data[POS], cpu.valid_mask(), samples["cpu"], k,
                  SEG_THRESHOLD)
    res = check_counts(what, counts[device], ref, counts["cpu"])
    card, mine = ransac(on[device], k, iters, seed), ransac(cpu, k, iters,
                                                              seed)
    winners_differ = geometry(card[0]) != geometry(mine[0])
    if winners_differ:
        wg, wc = (int(counts[device].argmax()), int(counts["cpu"].argmax()))
        gap = abs(int(counts["cpu"][wg]) - int(counts["cpu"][wc]))
        if gap > int(ref["near"][wg] + ref["near"][wc]):
            raise AssertionError(f"{what}: winners {wg} and {wc} differ by "
                                 f"{gap} counts")
        print(json.dumps({"phase": "path_segmentation_cpu_winner",
                          "k": k, "card": wg, "cpu": wc, "gap": gap}),
              flush=True)
    return {"points": SEG_CROSS_N, "same_hypotheses": True, **res,
            "winners_differ": winners_differ}


def phase_path_segmentation(smi: str, device=None) -> PointBatch:
    """Ground extraction and line fitting on an airborne tile:
    ``ransac_plane_device(batch, 0.05, 1024, seed=1)`` on SEG_PLANE_N
    points and ``ransac_line_device(batch, 0.05, 256)`` on SEG_LINE_N, each
    gated (:func:`gate_segmentation`, :func:`cross_check_cpu`) before it is
    timed: the call's time (median of 5), hypothesis x points a second, the
    device's busy time and the peak of the memory it allocates.  Returns
    the plane's batch for ``--profile``."""
    dev = resolve_device(device)
    plane_batch = None
    for k, scene, iters, seed in ((3, plane_scene, SEG_PLANE_ITERS, 1),
                                  (2, wire_scene, SEG_LINE_ITERS, 0)):
        t0 = time.perf_counter()
        pos, own = scene()
        gate = gate_segmentation(pos, own, k, iters, seed, dev)
        batch = gate.pop("batch")
        cross = cross_check_cpu(pos, k, iters, seed, dev)
        gate_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ransac(batch, k, iters, seed)
        peak = torch.cuda.max_memory_allocated() - base
        ms, lo, hi = step_ms(lambda i: ransac(batch, k, iters, seed),
                             warmup=1, reps=5)
        prof = gpu_profile(lambda i: ransac(batch, k, iters, seed), steps=2)
        scored = gate["scored_hypotheses"] * len(pos)
        print(json.dumps({
            "phase": "path_segmentation",
            "model": "plane" if k == 3 else "line",
            "threshold": SEG_THRESHOLD, "seed": seed, **gate,
            "cpu_cross_check": cross, "gate_s": gate_s,
            "step_ms": ms, "step_ms_min": lo, "step_ms_max": hi,
            "repeats": 5,
            "mhypothesis_points_per_s": scored / ms / 1e3,
            "device_busy_ms": prof["device_busy_ms_per_step"],
            "device_launches": prof["device_launches_per_step"],
            "peak_memory_bytes": peak,
            "batch_bytes": pos.nbytes, "top": prof["top"][:5],
            "card": smi}), flush=True)
        if k == 3:
            plane_batch = batch
    return plane_batch


# ---- convex hull -----------------------------------------------------------------

def check_hull(what: str, pos: np.ndarray, tris: np.ndarray,
               points: np.ndarray) -> int:
    """The hull's vertex set equals scipy's (qhull) and the vertices of
    ``convex_hull_as_points``; every point on the inner side of every face;
    V = F/2 + 2.  Returns the vertex count."""
    from scipy.spatial import ConvexHull

    verts = np.unique(tris)
    if set(verts.tolist()) != set(ConvexHull(pos).vertices.tolist()) \
            or not np.array_equal(verts, np.unique(points)):
        raise AssertionError(f"{what}: hull vertices differ from qhull's")
    scale = max(1.0, float(np.abs(pos).max())) ** 2
    a, b, c = pos[tris[:, 0]], pos[tris[:, 1]], pos[tris[:, 2]]
    normal = np.cross(b - a, c - a)
    offset = np.einsum("ij,ij->i", normal, a)
    for i in range(0, len(pos), 1 << 14):
        side = pos[i:i + (1 << 14)] @ normal.T - offset
        if not (side <= 1e-9 * scale).all():
            raise AssertionError(f"{what}: a point lies outside a face")
    if len(verts) != len(tris) // 2 + 2:
        raise AssertionError(f"{what}: {len(verts)} vertices, {len(tris)} "
                             f"faces")
    return len(verts)


def phase_path_hull(smi: str, device=None) -> None:
    """``convex_hull_as_triangle_mesh`` and ``convex_hull_as_points`` on
    uniform cubes of HULL_SIZES points (benches/host_benches.py's), the
    largest given as a batch on the card (its f32 positions come to the
    host as f64); gated by :func:`check_hull`, then seconds each (median of
    3).  The hull is host code: the card only holds the input."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    sizes = {}
    for n in HULL_SIZES:
        pos = rng.uniform(-100.0, 100.0, (n, 3))
        src = positions_buffer(pos)
        if n == HULL_SIZES[-1]:
            src = PointBatch.from_host(src, device=dev)
            pos = pos.astype(np.float32).astype(np.float64)
        what = f"path_hull ({n})"
        tris = hull_mod.convex_hull_as_triangle_mesh(src)
        points = hull_mod.convex_hull_as_points(src)
        verts = check_hull(what, pos, tris, points)
        runs = {}
        for name, fn in (("triangle_mesh_s",
                          hull_mod.convex_hull_as_triangle_mesh),
                         ("points_s", hull_mod.convex_hull_as_points)):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn(src)
                times.append(time.perf_counter() - t0)
            runs[name] = float(np.median(times))
        sizes[str(n)] = {"faces": len(tris), "vertices": verts,
                         "input": "cuda batch" if n == HULL_SIZES[-1]
                         else "host buffer", **runs}
    print(json.dumps({"phase": "path_hull", "sizes": sizes,
                      "equal_to_qhull": True, "card": smi}), flush=True)


# ---- CRS reprojection ------------------------------------------------------------

def reproject_tile(n: int = REPROJ_N, seed: int = 41) -> np.ndarray:
    """A 2 km survey tile in ETRS89 / UTM 32N near Frankfurt: eastings
    476 000-478 000 m, northings 5 550 000-5 552 000 m, heights 90-400 m."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(476000.0, 478000.0, n),
                     rng.uniform(5550000.0, 5552000.0, n),
                     rng.uniform(90.0, 400.0, n)], axis=1)


def check_golden() -> int:
    """The builtin engine on the 19 cases of the golden file (PROJ-made),
    each within its ``tol``."""
    cases = json.loads(GOLDEN.read_text())
    for case in cases:
        p = reproj_mod.Projection(case["src"], case["dst"],
                                  backend="builtin")
        err = np.abs(p.transform(np.asarray(case["points"], np.float64))
                     - np.asarray(case["expected"])).max()
        if not err < case["tol"]:
            raise AssertionError(f"path_reproject: golden {case['name']} "
                                 f"off by {err}")
    return len(cases)


def degrees_to_m(dlonlat: np.ndarray, lat: np.ndarray) -> np.ndarray:
    """Ground distance of small (lon, lat) differences in degrees."""
    m = np.pi / 180.0 * 6378137.0
    return np.hypot(dlonlat[:, 0] * m * np.cos(np.radians(lat)),
                    dlonlat[:, 1] * m)


def phase_path_reproject(smi: str, device=None) -> None:
    """A survey tile (REPROJ_N points, an f64 batch on the card) reprojected
    from ETRS89 / UTM 32N to WGS 84 and back by
    ``reproject_point_cloud_within`` with the builtin engine.  Gates: the
    golden cases; the column still on the card in f64; the round trip
    within 10 µm; where ``libproj`` loads, the builtin result within 1e-4 m
    of its.  Then each direction timed (median of 2) beside the two copies
    between host and card that it makes."""
    dev = resolve_device(device)
    golden = check_golden()
    pos = reproject_tile()
    batch = PointBatch.from_host(positions_buffer(pos),
                                 policy=dt.DevicePolicy.EXACT, device=dev)

    def run(src, dst):
        t0 = time.perf_counter()
        reproj_mod.reproject_point_cloud_within(batch, src, dst,
                                                backend="builtin")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    times = {"forward_s": [run(REPROJ_SRC, REPROJ_DST)]}
    col = batch.data[POS]
    if col.device != dev or col.dtype != torch.float64 \
            or col.shape != (REPROJ_N, 3):
        raise AssertionError(f"path_reproject: column {col.dtype} "
                             f"{tuple(col.shape)} on {col.device}")
    geo = col.cpu().numpy()
    times["inverse_s"] = [run(REPROJ_DST, REPROJ_SRC)]
    trip = float(np.abs(batch.data[POS].cpu().numpy() - pos).max())
    if not trip < 1e-5:
        raise AssertionError(f"path_reproject: round trip off by {trip} m")
    vs_proj = None
    if native_proj.AVAILABLE:
        other = reproj_mod.Projection(REPROJ_SRC, REPROJ_DST,
                                      backend="proj").transform(pos)
        vs_proj = float(degrees_to_m(geo[:, :2] - other[:, :2],
                                     geo[:, 1]).max())
        dz = float(np.abs(geo[:, 2] - other[:, 2]).max())
        if not (vs_proj < 1e-4 and dz < 1e-4):
            raise AssertionError(f"path_reproject: builtin off libproj by "
                                 f"{vs_proj} m, {dz} m in height")
    times["forward_s"].append(run(REPROJ_SRC, REPROJ_DST))
    times["inverse_s"].append(run(REPROJ_DST, REPROJ_SRC))
    copies = []
    for _ in range(3):
        t0 = time.perf_counter()
        host = batch.data[POS].cpu().numpy()
        torch.from_numpy(host).to(dev)
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t0)
    fwd = float(np.median(times["forward_s"]))
    copy_s = float(np.median(copies))
    print(json.dumps({
        "phase": "path_reproject", "points": REPROJ_N, "src": REPROJ_SRC,
        "dst": REPROJ_DST, "backend": "builtin",
        "proj_available": native_proj.AVAILABLE, "golden_cases": golden,
        "round_trip_max_err_m": trip, "builtin_vs_libproj_max_m": vs_proj,
        "column": "float64 on the card", **times,
        "forward_mpoints_per_s": REPROJ_N / fwd / 1e6,
        "inverse_mpoints_per_s":
            REPROJ_N / float(np.median(times["inverse_s"])) / 1e6,
        "copies_s": copy_s, "copies_share_of_forward": copy_s / fwd,
        "card": smi}), flush=True)


# ---- the distributed layer -----------------------------------------------------

DIST_SIZE = 4                 # world (b): four ranks sharing the one card
DIST_PIPE_SCANS = 3           # cut from 4 for the run's time: PERF.md
DIST_DIR = "_distributed"     # under the checkout; removed after the phase
DIST_AGREE_M = 1e-4           # world (b) against (a): replicated ICP, poses
DIST_HALO_AGREE_M = 2e-2      # partitioned ICP and pipeline (dryrun's bound)
MESH2D_AXES = ("hosts", "points")   # world (b)'s four ranks as a 2-D mesh
MESH2D_TWIN_M = 1e-9          # the pose graph's hosts twins (float atomics)
#: the kernel counters a step's launches are read from
DIST_COUNTERS = ("tile_sort", "fused_sorted_voxel_reduce_quantized",
                 "blockwise_compact", "window_fit_moments")


def dist_config(**overrides) -> dict:
    """The phase's sizes: those of the single-card paths (the main path's
    batch in 8192 tiles, the normals surface, the trajectory's scans, the
    pose-graph sweep's circle graph, 2**20-point LAS files); the tests
    rehearse it with small ones.  ``device`` None is the card, ``backend``
    None NCCL on it."""
    cfg = {"n": N, "ztiles": ZTILES, "xtiles": XTILES, "normals_n":
           NORMALS_N, "scan_n": TRAJ_N, "scene_size": TRAJ_SIZE,
           "loop": TRAJ_SCANS, "pipe_scans": DIST_PIPE_SCANS,
           "icp_voxel": REG_VOXEL,
           "icp_iters": 20, "halo": 512, "capacity": 4.0,
           "pose": {"dense": 1024, "cg": 1024, "cg_large": 20000},
           "pose_iters": POSE_ITERS, "read_n": 1 << 20, "read_files": 4,
           "cross_n": 1 << 16, "mesh2d": (2, 2), "device": None,
           "backend": None}
    cfg.update(overrides)
    return cfg


def _np_of(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prepare_distributed(work: Path, cfg: dict, wbatch: PointBatch,
                        surface: np.ndarray) -> dict:
    """Write the ranks' inputs under ``work`` and compute the single-device
    references on ``cfg["device"]``: the batch's bounds, path B (ii) with
    the sharded origin, the one-shot voxelization, the ICP pair's
    single-device ICP and truth, the dense pose graph, the pipeline over
    the same scans."""
    work.mkdir(parents=True, exist_ok=True)
    dev = resolve_device(cfg["device"])
    n = wbatch.capacity
    tick = time.perf_counter()
    for name in (POS, INT, CLS):
        np.save(work / f"wbatch_{name}.npy", _np_of(wbatch.data[name]))
    np.save(work / "surface.npy", surface)
    refs = {"n": n, "normals_n": len(surface)}
    aabb = algorithms.calculate_bounds(wbatch)
    refs["bounds"] = (aabb.min, aabb.max)
    bmin = torch.from_numpy(aabb.min.astype(np.float32)).to(dev)
    tiles = cfg["ztiles"] * cfg["xtiles"]
    q = path_quantized_internal(wbatch, bmin, tiles)
    one = voxel_downsample(wbatch, LEAF, semantics="floor")
    for key, vb in (("quantized", q), ("merged", one)):
        c = int(vb.count.item())
        refs[key] = {k: _np_of(vb.data[k][:c]) for k in (POS, INT, CLS)}
    del q, one
    refs["positions_sorted"] = _rows_sorted(_np_of(wbatch.data[POS]))
    sec = {"voxel_references": time.perf_counter() - tick}
    tick = time.perf_counter()

    poses = trajectory_poses(cfg["loop"])
    scans = [trajectory_scan(i, poses, n=cfg["scan_n"],
                             size=cfg["scene_size"])
             for i in range(cfg["pipe_scans"])]
    np.save(work / "scans.npy", np.stack(scans))
    down = RegistrationPipeline(voxel_size=cfg["icp_voxel"], device=dev)
    src, tgt = down._downsample(scans[1]), down._downsample(scans[0])
    anchor = tgt.min(axis=0)
    # the truth, scan 1's frame into scan 0's, in the anchored frame
    r0, t0 = poses[0][0], poses[1][0]
    rot = r0.T @ poses[0][1]
    trans = r0.T @ (poses[1][1] - t0) + rot @ anchor - anchor
    refs["icp_truth"] = (rot, trans)
    clouds = {"source": src - anchor, "target": tgt - anchor,
              # scan 0's keyframe moved into scan 1's frame: the pair on
              # which point-to-point ICP can meet the truth (fresh draws
              # bias it; see PERF.md)
              "moved": (tgt - anchor - trans) @ rot}
    for name, c in clouds.items():
        np.save(work / f"icp_{name}.npy", c.astype(np.float32))
    refs["icp_points"] = (len(src), len(tgt))
    sec["scans"] = time.perf_counter() - tick
    tick = time.perf_counter()
    on = {k: torch.from_numpy(c.astype(np.float32)).to(dev)
          for k, c in clouds.items()}
    for name, plane in (("icp", False), ("icp_plane", True)):
        res = icp(on["source"], on["target"], iterations=cfg["icp_iters"],
                  point_to_plane=plane)
        refs[name] = (_np_of(res.rotation), _np_of(res.translation))
    sec["icp"] = time.perf_counter() - tick
    tick = time.perf_counter()

    graph, _ = circle_graph(cfg["pose"]["dense"], device=dev)
    opt, _ = optimize_pose_graph(graph, iterations=cfg["pose_iters"])
    refs["pose_dense"] = _np_of(opt.translations)

    pipe = RegistrationPipeline(voxel_size=cfg["icp_voxel"],
                                keyframe_distance=0.05,
                                icp_iterations=cfg["icp_iters"], device=dev)
    for scan in scans:
        pipe.add_scan(scan)
    refs["pipeline"] = (np.stack([kf.rotation for kf in pipe.keyframes]),
                        pipe.trajectory())
    refs["poses"] = (poses[0][:cfg["pipe_scans"]],
                     poses[1][:cfg["pipe_scans"]])
    sec["pose_graph_and_pipeline"] = time.perf_counter() - tick
    tick = time.perf_counter()

    survey = make_survey(cfg["read_n"] * cfg["read_files"])
    paths = []
    for i in range(cfg["read_files"]):
        path = work / f"survey_{i}.las"
        write_all(survey.slice(i * cfg["read_n"], (i + 1) * cfg["read_n"]),
                  path)
        paths.append(str(path))
    refs["read_paths"] = paths
    sec["las_files"] = time.perf_counter() - tick
    refs["seconds"] = sec
    return refs


def _rows_sorted(pos: np.ndarray) -> np.ndarray:
    """The rows of ``pos`` in lexicographic order of their bit patterns
    (a multiset's canonical form)."""
    bits = np.ascontiguousarray(pos).view(np.int32)
    return pos[np.lexsort(bits.T[::-1])]


def load_prebuilt() -> tuple:
    """Load the kernels the first process built (no ``nvcc`` here: every
    library must already be there).  Returns ``(seconds, sources)``."""
    t0 = time.perf_counter()
    missing = [s for s in _build.SOURCES if not _build._target(s).exists()]
    if missing:
        raise AssertionError(f"kernels {missing} not built before the "
                             f"ranks started")
    _build.build_all()
    return time.perf_counter() - t0, sorted(_build.SOURCES)


@contextlib.contextmanager
def capturing(captured: dict):
    """Record the first inputs the distributed path hands K4, K3'q, the
    merge's K5 and K6 (for their kernel rows)."""
    def first(name, fn):
        def run(*a, **kw):
            if name not in captured:
                captured[name] = (tuple(
                    x.clone() if isinstance(x, torch.Tensor) else
                    [s.clone() for s in x] if isinstance(x, list) else x
                    for x in a), dict(kw))
            return fn(*a, **kw)
        return run
    saved = (voxel_mod.tile_sort, voxel_mod.fused_sorted_voxel_reduce_rows,
             merge_mod.compact_columns, normals_mod.window_fit_moments)
    voxel_mod.tile_sort = first("tile_sort", saved[0])
    voxel_mod.fused_sorted_voxel_reduce_rows = first("reduce", saved[1])
    merge_mod.compact_columns = first("compact", saved[2])
    normals_mod.window_fit_moments = first("window_fit", saved[3])
    try:
        yield captured
    finally:
        (voxel_mod.tile_sort, voxel_mod.fused_sorted_voxel_reduce_rows,
         merge_mod.compact_columns, normals_mod.window_fit_moments) = saved


def positions_batch(pos: np.ndarray) -> PointBatch:
    """A CPU batch of f32 positions, every row valid."""
    schema = PointSchema.from_attributes([att.POSITION_3D])
    return PointBatch.from_columns(
        schema, {POS: torch.from_numpy(np.ascontiguousarray(
            pos, np.float32))}, device="cpu")


def _dist_inputs(work: Path):
    cols = {k: torch.from_numpy(np.load(work / f"wbatch_{k}.npy"))
            for k in (POS, INT, CLS)}
    schema = PointSchema.from_attributes(
        [att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION])
    return PointBatch.from_columns(schema, cols, device="cpu")


def distributed_world(rank: int, size: int, work: str, cfg: dict,
                      capture: dict = None) -> dict:
    """Rank ``rank`` of a world of ``size``: every entry point of the
    distributed layer on the mesh of the whole world, at ``cfg``'s sizes,
    each step's launches (K3'q, K4, K5, K6), collectives and seconds
    recorded.  The steps that take milliseconds run once for the gates and
    once timed; ICP, pose graph, read and pipeline run once, timed.
    Returns what :func:`gate_distributed` checks and the phase prints:
    this rank's shards, the replicated results, the counts and times."""
    work = Path(work)
    dev = resolve_device(cfg["device"])
    out = {"rank": rank, "size": size, "seconds": {}, "launches": {},
           "collectives": {}}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        out["build_s"], _ = load_prebuilt()
    mesh = parallel.make_mesh(size, device=dev, backend=cfg["backend"])
    out["backend"] = mesh.backend
    wb = _dist_inputs(work)
    surface = np.load(work / "surface.npy")
    tiles = cfg["ztiles"] * cfg["xtiles"]
    halo = cfg["halo"]

    def step(name, fn, again: bool = False, rec: dict = out):
        parallel.reset_collective_counts()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        sec = time.perf_counter() - t0
        after = kernels.launch_counts()
        rec["launches"][name] = {c: after[c] - before[c]
                                 for c in DIST_COUNTERS}
        rec["collectives"][name] = parallel.collective_counts()
        if again:
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            sec = time.perf_counter() - t0
        rec["seconds"][name] = sec
        return res

    shard = parallel.shard_batch(wb, mesh)
    pos_only = parallel.shard_batch(PointBatch(
        {POS: wb.data[POS]}, wb.count, wb.schema, {}), mesh)
    nshard = parallel.shard_batch(positions_batch(surface), mesh)
    qkw = dict(grid_bits=10, position_quantization_bits=QBITS,
               sort_tiles=tiles // size)

    def partition():
        p = parallel.morton_partition(pos_only, mesh, capacity_factor=size,
                                      sort_local=True)
        return p, parallel.halo_exchange(p[0], p[1], mesh, halo)
    # the steps that take milliseconds: gated, then timed
    cheap = {
        "sharded_bounds": lambda: parallel.sharded_bounds(shard, mesh),
        "sharded_voxel_downsample": lambda: parallel.sharded_voxel_downsample(
            shard, mesh, LEAF, **qkw),
        "sharded_voxel_downsample_merged":
            lambda: parallel.sharded_voxel_downsample_merged(
                shard, mesh, LEAF, mode_runs=True),
        "morton_partition_halo": partition,
        "distributed_normals": lambda: parallel.distributed_normals(
            nshard, mesh, NORMALS_K, window=NORMALS_WINDOW)}
    with (capturing(capture) if capture is not None
          else contextlib.nullcontext()):
        got = {name: step(name, fn, again=True)
               for name, fn in cheap.items()}
    (mn, mx), (vox, vcounts), (merged, maux), \
        ((part, pcounts, pdropped), (hcols, hcounts)), \
        (npart, nrm, _, ncounts, ndropped) = got.values()
    del got
    out["bounds"] = (_np_of(mn), _np_of(mx))
    nq = int(vcounts[rank])
    out["quantized"] = {"counts": _np_of(vcounts),
                        **{k: _np_of(vox.data[k][:nq])
                           for k in (POS, INT, CLS)}}
    if rank == 0:
        nm = int(merged.count.item())
        out["merged"] = {"points": int(maux["counts"].sum()),
                         **{k: _np_of(merged.data[k][:nm])
                            for k in (POS, INT, CLS)}}
    del merged, maux, vox
    c = int(pcounts[rank])
    out["partition"] = {"counts": _np_of(pcounts),
                        "dropped": _np_of(pdropped),
                        "pos": _np_of(part.data[POS][:c]),
                        "halo_counts": _np_of(hcounts),
                        "halo_pos": _np_of(hcols[POS])}
    cn = int(ncounts[rank])
    npos = _np_of(npart.data[POS][:cn])
    out["normals"] = {"n": cn, "dropped": _np_of(ndropped),
                      "within_6deg": within_degrees(_np_of(nrm[:cn]), npos)
                      * cn}
    del part, hcols, npart, nrm

    src, tgt, moved = (torch.from_numpy(np.load(work / f"icp_{k}.npy"))
                       for k in ("source", "target", "moved"))
    tgt_dev = tgt.to(dev)

    def pose_of(r):
        return {"rotation": _np_of(r.rotation),
                "translation": _np_of(r.translation),
                "inliers": int(r.num_inliers), "rmse": float(r.rmse)}

    def rows_of(c):
        """This rank's rows of the source padded to a multiple of size."""
        per = -(-c.shape[0] // size)
        pad = torch.cat([c, c.new_zeros((per * size - c.shape[0], 3))])
        return pad[rank * per:(rank + 1) * per].to(dev), c.shape[0]
    for name, c in (("icp", src), ("icp_moved", moved)):
        rows, count = rows_of(c)
        res = step(f"distributed_{name}", lambda: parallel.distributed_icp(
            rows, tgt_dev, mesh, source_count=count,
            iterations=cfg["icp_iters"]))
        out[name] = pose_of(res)

    clouds = [parallel.shard_batch(positions_batch(p.numpy()), mesh)
              for p in (src, tgt)]
    res, dropped = step("distributed_icp_partitioned",
                        lambda: parallel.distributed_icp_partitioned(
                            *clouds, mesh, halo=halo,
                            capacity_factor=cfg["capacity"],
                            iterations=cfg["icp_iters"],
                            point_to_plane=True))
    out["icp_partitioned"] = {**pose_of(res), "dropped": int(dropped)}

    out["pose_graph"] = {}
    for name, poses in cfg["pose"].items():
        solver = "dense" if name == "dense" else "cg"
        graph, true_t = circle_graph(poses, device=dev)
        opt, costs = step(f"pose_graph_{name}",
                          lambda: parallel.distributed_pose_graph(
                              graph, mesh, iterations=cfg["pose_iters"],
                              solver=solver,
                              **(POSE_CG_KW if solver == "cg" else {})))
        out["pose_graph"][name] = {
            "poses": poses, "costs": _np_of(costs),
            "translations": _np_of(opt.translations),
            "ate_m": float(np.linalg.norm(_np_of(opt.translations) - true_t,
                                          axis=1).mean())}

    paths = sorted(str(p) for p in work.glob("survey_*.las"))
    got = step("sharded_read_all",
               lambda: parallel.sharded_read_all(paths, mesh))
    host = HostPointBuffer.concat([read_all(p) for p in paths])
    per = got.capacity          # this rank's rows of the padded whole
    want = host.slice(min(rank * per, len(host)),
                      min((rank + 1) * per, len(host)))
    nr = int(got.count.item())
    out["read"] = {"rows": nr, "device": str(got.device), "equal": (
        nr == len(want) and all(np.array_equal(
            _np_of(got.data[k][:nr]),
            want.columns[k].astype(_np_of(got.data[k]).dtype))
            for k in want.columns))}
    del got, host

    scans = np.load(work / "scans.npy", mmap_mode="r")

    def pipeline():
        pipe = RegistrationPipeline(voxel_size=cfg["icp_voxel"],
                                    keyframe_distance=0.05,
                                    icp_iterations=cfg["icp_iters"],
                                    mesh=mesh)
        for scan in scans:
            pipe.add_scan(np.asarray(scan))
        return pipe
    pipe = step("pipeline", pipeline)
    out["pipeline"] = (np.stack([kf.rotation for kf in pipe.keyframes]),
                       pipe.trajectory())

    if size > 1 and dev.type == "cuda" and cfg["cross_n"]:
        # the card's partition against the same ranks' gloo partition on
        # the CPU, bit for bit
        cpu_mesh = parallel.make_mesh(size, device="cpu")
        cut = PointBatch({POS: wb.data[POS][:cfg["cross_n"]]},
                         torch.tensor(cfg["cross_n"], dtype=torch.int32),
                         wb.schema, {})
        on = [parallel.morton_partition(parallel.shard_batch(cut, m), m,
                                        capacity_factor=size,
                                        sort_local=True)
              for m in (mesh, cpu_mesh)]
        out["cross_cpu"] = {"n": cfg["cross_n"], "equal": all(
            torch.equal(x.cpu(), y) for x, y in
            ((on[0][0].data[POS], on[1][0].data[POS]),
             (on[0][1], on[1][1]), (on[0][2], on[1][2])))}
    if dev.type == "cuda":
        # device busy over one more pass of the cheap steps
        def one_pass(i=0):
            for fn in cheap.values():
                fn()
        out["busy"] = busy_pass(rank, one_pass)
    if size > 1 and size == math.prod(cfg["mesh2d"]):
        out["mesh2d"] = distributed_mesh2d(rank, work, cfg, dev, wb, surface,
                                           step)
    return out


def busy_pass(rank: int, one_pass):
    """Rank 0's device busy over one more pass (``torch.profiler``); every
    rank runs the pass, as its collectives need them all."""
    if rank != 0:
        one_pass()
        return None
    prof = gpu_profile(one_pass, steps=1, warm=False)
    return {"traced_ms": prof["traced_wall_ms_per_step"],
            "busy_ms": prof["device_busy_ms_per_step"],
            "launches": prof["device_launches_per_step"]}


def _digest(tree) -> str:
    """A hash of the bytes of every array of ``tree`` (dicts in key order),
    to hold two ranks' results equal without shipping them."""
    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                feed(x[k])
        elif isinstance(x, (tuple, list)):
            for v in x:
                feed(v)
        else:
            a = np.ascontiguousarray(x)
            h.update(str((a.dtype, a.shape)).encode())
            h.update(a.tobytes())
    feed(tree)
    return h.hexdigest()


def distributed_mesh2d(rank: int, work: Path, cfg: dict, dev, wb: PointBatch,
                       surface: np.ndarray, step) -> dict:
    """World (b)'s ranks as a ``MESH2D_AXES`` mesh of ``cfg["mesh2d"]``:
    the main path's steps over ``"points"`` at its sizes (each ``points``
    line holds the whole batch, half a rank), recorded by ``step`` as the
    1-D steps are.  Every rank returns a digest of each step's results
    (the ``hosts`` rows must agree bit for bit) and the ranks of the first
    ``hosts`` row their shards for :func:`gate_mesh2d`; on the card rank 0
    holds K3'q and K5 against their plain versions on the inputs the steps
    gave them, then reads its device busy over one pass of the millisecond
    steps.  The pose graph's translations come back from every rank: its
    sums are float atomics on the card, so its ``hosts`` twins agree to a
    bound, not bit for bit."""
    ax = "points"
    t0 = time.perf_counter()
    mesh = parallel.make_mesh(math.prod(cfg["mesh2d"]), MESH2D_AXES,
                              cfg["mesh2d"], device=dev,
                              backend=cfg["backend"])
    line = mesh.along(ax)
    rec = {"coords": mesh.coords, "mesh_s": time.perf_counter() - t0,
           "seconds": {}, "launches": {}, "collectives": {}}
    tiles = cfg["ztiles"] * cfg["xtiles"]
    halo = cfg["halo"]
    shard = parallel.shard_batch(wb, mesh, ax)
    pos_only = parallel.shard_batch(PointBatch(
        {POS: wb.data[POS]}, wb.count, wb.schema, {}), mesh, ax)
    nshard = parallel.shard_batch(positions_batch(surface), mesh, ax)
    qkw = dict(grid_bits=10, position_quantization_bits=QBITS,
               sort_tiles=tiles // line.size)

    def partition():
        p = parallel.morton_partition(pos_only, mesh, ax,
                                      capacity_factor=line.size,
                                      sort_local=True)
        return p, parallel.halo_exchange(p[0], p[1], mesh, halo, ax)
    cheap = {
        "sharded_bounds": lambda: parallel.sharded_bounds(shard, mesh, ax),
        "sharded_voxel_downsample": lambda: parallel.sharded_voxel_downsample(
            shard, mesh, LEAF, ax, **qkw),
        "sharded_voxel_downsample_merged":
            lambda: parallel.sharded_voxel_downsample_merged(
                shard, mesh, LEAF, ax, mode_runs=True),
        "morton_partition_halo": partition,
        "distributed_normals": lambda: parallel.distributed_normals(
            nshard, mesh, NORMALS_K, window=NORMALS_WINDOW, axis=ax)}
    captured = {}
    hold = rank == 0 and dev.type == "cuda"
    with (capturing(captured) if hold else contextlib.nullcontext()):
        got = {name: step(name, fn, again=True, rec=rec)
               for name, fn in cheap.items()}
    (mn, mx), (vox, vcounts), (merged, maux), \
        ((part, pcounts, pdropped), (hcols, hcounts)), \
        (npart, nrm, _, ncounts, ndropped) = got.values()
    del got
    r = line.rank
    res = {"bounds": (_np_of(mn), _np_of(mx))}
    nq = int(vcounts[r])
    res["quantized"] = {"counts": _np_of(vcounts),
                        **{k: _np_of(vox.data[k][:nq])
                           for k in (POS, INT, CLS)}}
    nm = int(merged.count.item())
    res["merged"] = {"points": int(maux["counts"].sum()),
                     **{k: _np_of(merged.data[k][:nm])
                        for k in (POS, INT, CLS)}}
    del merged, maux, vox
    c = int(pcounts[r])
    res["partition"] = {"counts": _np_of(pcounts),
                        "dropped": _np_of(pdropped),
                        "pos": _np_of(part.data[POS][:c]),
                        "halo_counts": _np_of(hcounts),
                        "halo_pos": _np_of(hcols[POS])}
    cn = int(ncounts[r])
    npos = _np_of(npart.data[POS][:cn])
    nn = _np_of(nrm[:cn])
    res["normals"] = {"n": cn, "dropped": _np_of(ndropped),
                      "within_6deg": within_degrees(nn, npos) * cn}
    rec["digest"] = {"normals": _digest((npos, nn))}
    del part, hcols, npart, nrm

    src, tgt = (np.load(work / f"icp_{k}.npy") for k in ("source", "target"))
    clouds = [parallel.shard_batch(positions_batch(p), mesh, ax)
              for p in (src, tgt)]
    icp_res, dropped = step(
        "distributed_icp_partitioned",
        lambda: parallel.distributed_icp_partitioned(
            *clouds, mesh, ax, halo=halo, capacity_factor=cfg["capacity"],
            iterations=cfg["icp_iters"], point_to_plane=True), rec=rec)
    res["icp_partitioned"] = {"rotation": _np_of(icp_res.rotation),
                              "translation": _np_of(icp_res.translation),
                              "inliers": int(icp_res.num_inliers),
                              "dropped": int(dropped)}
    graph, _ = circle_graph(cfg["pose"]["cg"], device=dev)
    opt, costs = step("pose_graph_cg", lambda: parallel.distributed_pose_graph(
        graph, mesh, ax, iterations=cfg["pose_iters"], solver="cg",
        **POSE_CG_KW), rec=rec)
    res["pose_graph_cg"] = {"poses": cfg["pose"]["cg"],
                            "costs": _np_of(costs),
                            "translations": _np_of(opt.translations)}
    # the pose graph's block sums are index_add_ on the card (float
    # atomics, in no fixed order): its twins are held within a bound
    rec["digest"].update({k: _digest(v) for k, v in res.items()
                          if k not in ("normals", "pose_graph_cg")})
    rec["pose_graph_cg"] = res["pose_graph_cg"]["translations"]
    if mesh.coords[0] == 0:
        rec["results"] = res
    if hold:
        rec["held"] = hold_captured(captured)
    if dev.type == "cuda":
        def one_pass(i=0):
            for fn in cheap.values():
                fn()
        rec["busy"] = busy_pass(rank, one_pass)
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def hold_reduce_quantized(args: tuple, kw: dict, what: str):
    """K3'q against its plain version on the arguments a step gave it;
    raises unless they agree.  Returns ``(max_abs_err, voxels)``."""
    kpos, kword, kcount = vr.fused_sorted_voxel_reduce_rows(*args, **kw)
    ppos, pword, pcount = vr.fused_sorted_voxel_reduce_plain(*args, **kw)
    torch.cuda.synchronize()
    nv = int(kcount.item())
    err = (kpos - ppos).abs().max().item()
    if nv != int(pcount.item()) or not torch.equal(u32_carrier(kword),
                                                   pword) or err != 0.0:
        raise AssertionError(f"fused_sorted_voxel_reduce (quantized) on "
                             f"{what} differs from its plain version")
    return err, nv


def hold_captured(captured: dict) -> dict:
    """K3'q and the merge's K5 against their plain versions on the inputs
    a step gave them (the 2-D mesh's shard, on rank 0): their shapes and
    the largest difference, which must be 0."""
    args, kw = captured["reduce"]
    err, _ = hold_reduce_quantized(args, kw, "the 2-D mesh's shard")
    (cols, keep), _ = captured["compact"]
    kept = hold_compaction(list(cols), keep, "the 2-D mesh's merge")
    return {"fused_sorted_voxel_reduce_quantized": {
                "rows": int(args[0].shape[0]), "max_abs_err": err},
            "blockwise_compact": {"rows": int(keep.shape[0]),
                                  "kept": kept, "max_abs_err": 0.0}}


def _max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _rotation_deg(a: np.ndarray, b: np.ndarray) -> float:
    chord = np.linalg.norm(a - b) / np.sqrt(8.0)
    return float(np.rad2deg(2.0 * np.arcsin(min(chord, 1.0))))


def gate_distributed(world: list, refs: dict, cfg: dict) -> dict:
    """The phase's gates on one world's ranks against the single-device
    references (see the docstring of :func:`phase_path_distributed`).
    Raises on the first that fails; returns what it measured."""
    size = len(world)
    cuda = resolve_device(cfg["device"]).type == "cuda"
    g = {}

    def fail(what, detail):
        raise AssertionError(f"path_distributed ({size} ranks): {what}: "
                             f"{detail}")

    g.update(gate_shards(world, refs, cfg, fail))
    # registration: truth, the single device, replicated on every rank
    # ICP: point-to-point on the scan pair = the single device (the truth
    # reported: fresh draws bias point-to-point), on the moved keyframe =
    # the truth; partitioned point-to-plane = the truth and the single
    # device's point-to-plane
    for name, single, bound, truth in (
            ("icp", "icp", 5e-3, False), ("icp_moved", None, None, True),
            ("icp_partitioned", "icp_plane", DIST_HALO_AGREE_M, True)):
        g[name] = gate_pose(world, name, refs, single, bound, truth, fail)
    pg = world[0]["pose_graph"]
    for name, p in pg.items():
        if not p["costs"][-1] < p["costs"][0]:
            fail(f"pose_graph {name}", f"costs {p['costs']}")
    g["pose_dense_vs_single"] = _max_diff(pg["dense"]["translations"],
                                          refs["pose_dense"])
    g["pose_cg_vs_dense"] = _max_diff(pg["cg"]["translations"],
                                      pg["dense"]["translations"])
    g["pose_ate_m"] = {k: p["ate_m"] for k, p in pg.items()}
    if not (g["pose_dense_vs_single"] <= 1e-6
            and g["pose_cg_vs_dense"] <= 1e-6):
        fail("distributed_pose_graph", g)
    if not all(r["read"]["equal"] and r["read"]["device"] ==
               str(resolve_device(cfg["device"])) for r in world):
        fail("sharded_read_all", [r["read"] for r in world])
    rots, trans = world[0]["pipeline"]
    g["pipeline"] = pose_errors(rots, trans, refs["poses"])
    g["pipeline_vs_single_m"] = _max_diff(trans, refs["pipeline"][1])
    if not (g["pipeline"]["mean_m"] <= TRAJ_MEAN_M
            and g["pipeline"]["worst_m"] <= TRAJ_WORST_M
            and g["pipeline"]["rotation_deg"] <= TRAJ_ROT_DEG
            and g["pipeline_vs_single_m"] <= DIST_HALO_AGREE_M):
        fail("RegistrationPipeline(mesh=)", g)
    if cuda:
        for r in world:
            gate_launches(r["launches"], fail)
        if size > 1 and not all(r["cross_cpu"]["equal"] for r in world):
            fail("morton_partition", "the card's partition differs from "
                 "the CPU's")
    return g


def gate_launches(la: dict, fail) -> None:
    """A rank's kernel launches in the steps of the card's path: K4 and
    K3'q once in a shard's voxelize, K5 in the merge, K6 once in the
    normals."""
    q_l = la["sharded_voxel_downsample"]
    if q_l["tile_sort"] != 1 \
            or q_l["fused_sorted_voxel_reduce_quantized"] != 1:
        fail("sharded_voxel_downsample", f"launches {q_l}")
    if la["sharded_voxel_downsample_merged"]["blockwise_compact"] < 1:
        fail("sharded_voxel_downsample_merged", "K5 not launched")
    if la["distributed_normals"]["window_fit_moments"] != 1:
        fail("distributed_normals", f"launches {la['distributed_normals']}")


def gate_pose(world: list, name: str, refs: dict, single, bound, truth: bool,
              fail) -> dict:
    """An ICP step's pose on rank 0 against the truth and the single
    device's, and the same on every rank; nothing dropped."""
    rot_t, t_t = refs["icp_truth"]
    p = world[0][name]
    e_t = float(np.linalg.norm(p["translation"] - t_t))
    e_r = _rotation_deg(p["rotation"], rot_t)
    g = {"error_m": e_t, "error_deg": e_r, "inliers": p["inliers"]}
    if single is not None:
        g["vs_single"] = max(_max_diff(p["translation"], refs[single][1]),
                             _max_diff(p["rotation"], refs[single][0]))
        if not g["vs_single"] <= bound:
            fail(name, g)
    if truth and not (e_t <= 0.02 and e_r <= 0.2):
        fail(name, g)
    if p.get("dropped", 0):
        fail(name, f"dropped {p['dropped']}")
    for r in world[1:]:
        if _max_diff(r[name]["translation"], p["translation"]):
            fail(name, "not replicated")
    return g


def gate_shards(world: list, refs: dict, cfg: dict, fail) -> dict:
    """The gates of the millisecond steps on one line of ranks (shards in
    order): bounds, the shards' voxels, the merged voxels, the partition
    and halo, the normals."""
    size = len(world)
    g = {}
    for r in world:
        if not all(np.array_equal(np.asarray(x, np.float64), y)
                   for x, y in zip(r["bounds"], refs["bounds"])):
            fail("sharded_bounds", f"{r['bounds']} != {refs['bounds']}")

    # sharded voxelize (path B (ii) per shard) = path B (ii) with the
    # shards' origin, shards in rank order
    q = {k: np.concatenate([r["quantized"][k] for r in world])
         for k in (POS, INT, CLS)}
    ref = refs["quantized"]
    if len(q[POS]) != len(ref[POS]):
        fail("sharded_voxel_downsample", f"{len(q[POS])} voxels, single "
             f"device {len(ref[POS])}")
    for k in (INT, CLS):
        if not np.array_equal(q[k], ref[k]):
            fail("sharded_voxel_downsample", f"column {k} differs")
    g["quantized_voxels"] = len(q[POS])
    g["quantized_max_err"] = _max_diff(q[POS], ref[POS])
    if not np.array_equal(q[POS].view(np.int32), ref[POS].view(np.int32)):
        fail("sharded_voxel_downsample", f"centroids differ by "
             f"{g['quantized_max_err']}")

    m, ref = world[0]["merged"], refs["merged"]
    if len(m[POS]) != len(ref[POS]) or m["points"] != refs["n"]:
        fail("sharded_voxel_downsample_merged",
             f"{len(m[POS])} voxels of {m['points']} points, single device "
             f"{len(ref[POS])}")
    if not np.array_equal(m[CLS], ref[CLS]):
        fail("sharded_voxel_downsample_merged", "Classification differs")
    g["merged_intensity_max_diff"] = _max_diff(m[INT], ref[INT])
    g["merged_centroid_max_err"] = _max_diff(m[POS], ref[POS])
    if not (g["merged_intensity_max_diff"] <= 1 and np.allclose(
            m[POS], ref[POS], rtol=1e-5, atol=1e-5)):
        fail("sharded_voxel_downsample_merged", g)
    g["merged_voxels"] = len(m[POS])

    # partition and halo
    counts = world[0]["partition"]["counts"]
    shards = [r["partition"]["pos"] for r in world]
    if counts.sum() != refs["n"] or any(r["partition"]["dropped"].any()
                                        for r in world):
        fail("morton_partition", f"counts {counts}, dropped "
             f"{[r['partition']['dropped'] for r in world]}")
    if not np.array_equal(_rows_sorted(np.concatenate(shards)),
                          refs["positions_sorted"]):
        fail("morton_partition", "the points are not each present once")
    pmin = refs["bounds"][0].astype(np.float32)
    ext = np.float32(max((refs["bounds"][1] - refs["bounds"][0]).max(),
                         1e-9))
    keys = [_morton_u64(np.clip((s - pmin) / ext * (1 << 20), 0,
                                (1 << 20) - 1).astype(np.uint64))
            for s in shards]
    for d, kk in enumerate(keys):
        if np.any(kk[1:] < kk[:-1]):
            fail("morton_partition", f"shard {d} is not sorted")
    shift = np.uint64(60 - 12)
    ranges = [(kk.min(), kk.max()) for kk in keys if len(kk)]
    for lo, hi in zip(ranges[:-1], ranges[1:]):
        if (lo[1] >> shift) > (hi[0] >> shift) + np.uint64(1):
            fail("morton_partition", "shard key ranges out of order")
    halo = cfg["halo"]
    for d, r in enumerate(world):
        left, right = shards[(d - 1) % size], shards[(d + 1) % size]
        ln, rn = min(len(left), halo), min(len(right), halo)
        hp = r["partition"]["halo_pos"]
        if tuple(r["partition"]["halo_counts"]) != (ln, rn) \
                or not np.array_equal(hp[:ln], left[len(left) - ln:]) \
                or not np.array_equal(hp[halo:halo + rn], right[:rn]):
            fail("halo_exchange", f"rank {d}'s halo rows")
    g["partition_counts"] = counts.tolist()

    share = sum(r["normals"]["within_6deg"] for r in world) \
        / sum(r["normals"]["n"] for r in world)
    g["normals_within_6deg"] = share
    if sum(r["normals"]["n"] for r in world) != refs["normals_n"] \
            or any(r["normals"]["dropped"].any()
                                   for r in world) or not share >= 0.99:
        fail("distributed_normals", f"{share} within 6°")
    return g


def gate_mesh2d(world: list, refs: dict, cfg: dict) -> dict:
    """The 2-D mesh's gates on world (b)'s ranks (see
    :func:`distributed_mesh2d`): every step's results bit-equal on the two
    ``hosts`` rows, but the pose graph's within ``MESH2D_TWIN_M`` (its
    block sums are float atomics on the card); on the first row's ranks,
    the shards' gates (:func:`gate_shards`), partitioned point-to-plane ICP on the truth and
    within ``DIST_HALO_AGREE_M`` of the single device's, the CG pose graph
    within 1e-6 m of the single device's dense solve; on the card, the
    kernels' launches and rank 0's holds of K3'q and K5.  Raises on the
    first that fails; returns what it measured."""
    shape = tuple(cfg["mesh2d"])
    recs = [r["mesh2d"] for r in world]
    points = shape[MESH2D_AXES.index("points")]

    def fail(what, detail):
        raise AssertionError(f"path_distributed (mesh {shape} over "
                             f"{MESH2D_AXES}): {what}: {detail}")

    g = {"hosts_rows_equal": sorted(recs[0]["digest"]),
         "pose_cg_hosts_max_diff_m": 0.0}
    for r, rec in enumerate(recs):
        if rec["coords"] != tuple(int(c) for c in np.unravel_index(r, shape)):
            fail("make_mesh", f"rank {r} at {rec['coords']}")
        twin = recs[r % points]
        for k, d in rec["digest"].items():
            if d != twin["digest"][k]:
                fail(k, f"rank {r} differs from rank {r % points}, its "
                     f"hosts twin")
        diff = _max_diff(rec["pose_graph_cg"], twin["pose_graph_cg"])
        g["pose_cg_hosts_max_diff_m"] = max(g["pose_cg_hosts_max_diff_m"],
                                            diff)
        if not diff <= MESH2D_TWIN_M:
            fail("pose_graph_cg", f"rank {r} differs from its hosts twin by "
                 f"{diff} m")
    line = [rec["results"] for rec in recs[:points]]
    g.update(gate_shards(line, refs, cfg, fail))
    g["icp_partitioned"] = gate_pose(line, "icp_partitioned", refs,
                                     "icp_plane", DIST_HALO_AGREE_M, True,
                                     fail)
    pg = line[0]["pose_graph_cg"]
    if pg["poses"] != cfg["pose"]["dense"]:
        fail("distributed_pose_graph", "CG and the dense reference differ "
             "in size")
    g["pose_cg_vs_single_dense"] = _max_diff(pg["translations"],
                                             refs["pose_dense"])
    if not (pg["costs"][-1] < pg["costs"][0]
            and g["pose_cg_vs_single_dense"] <= 1e-6):
        fail("distributed_pose_graph", g)
    if resolve_device(cfg["device"]).type == "cuda":
        for rec in recs:
            gate_launches(rec["launches"], fail)
        g["held"] = recs[0].get("held")
        if not g["held"]:
            fail("kernels", "K3'q and K5 not held on rank 0")
    return g


def compare_worlds(a: list, b: list) -> dict:
    """World (b) against world (a): partition and merged voxels equal as
    sets and exactly in their integer columns; replicated ICP and the pose
    graph within ``DIST_AGREE_M``; partitioned ICP and the pipeline within
    ``DIST_HALO_AGREE_M``."""
    out = {}
    pa = a[0]["partition"]["pos"]
    pb = np.concatenate([r["partition"]["pos"] for r in b])
    out["partition_in_the_same_order"] = bool(np.array_equal(pa, pb))
    if not np.array_equal(_rows_sorted(pa), _rows_sorted(pb)):
        raise AssertionError("path_distributed: the worlds' partitions "
                             "differ")
    ma, mb = a[0]["merged"], b[0]["merged"]
    if len(ma[POS]) != len(mb[POS]) or not all(
            np.array_equal(ma[k], mb[k]) for k in (INT, CLS)):
        raise AssertionError("path_distributed: the worlds' merged voxels "
                             "differ")
    out["merged_centroid_max_diff"] = _max_diff(ma[POS], mb[POS])
    for name, bound in (("icp", DIST_AGREE_M), ("icp_moved", DIST_AGREE_M),
                        ("icp_partitioned", DIST_HALO_AGREE_M)):
        out[name] = _max_diff(a[0][name]["translation"],
                              b[0][name]["translation"])
        if not out[name] <= bound:
            raise AssertionError(f"path_distributed: {name} differs across "
                                 f"worlds by {out[name]} m")
    out["pose_graph"] = max(_max_diff(a[0]["pose_graph"][k]["translations"],
                                      b[0]["pose_graph"][k]["translations"])
                            for k in a[0]["pose_graph"])
    out["pipeline"] = _max_diff(a[0]["pipeline"][1], b[0]["pipeline"][1])
    if not (out["pose_graph"] <= DIST_AGREE_M
            and out["pipeline"] <= DIST_HALO_AGREE_M):
        raise AssertionError(f"path_distributed: worlds differ: {out}")
    return out


def distributed_rows(rows: list, captured: dict) -> None:
    """K4, K3'q, the merge's K5 and K6 at the shapes one rank of the
    one-rank world gave them, each held against its plain version, timed,
    added as rows of ``path_distributed``."""
    path = "path_distributed"
    (streams, tile_len), kw = captured["tile_sort"]
    dev = streams[0].device
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    tile_sort_row(rows, streams, tile_len, kw.get("num_keys", 1),
                  "tile_sort_distributed", path, flush)

    args, kw = captured["reduce"]
    err, nv = hold_reduce_quantized(args, kw, "the distributed path's inputs")
    n = args[0].shape[0]
    tl = args[9]
    add_row(rows, "fused_sorted_voxel_reduce_quantized_distributed",
            _CSRC + "voxel_reduce.cu", _TPU + "voxel_reduce_kernel.py:415",
            err, gpu_ms(lambda: vr.fused_sorted_voxel_reduce_rows(
                *args, **kw), flush),
            gpu_ms(lambda: vr.fused_sorted_voxel_reduce_plain(*args, **kw),
                   flush, reps=5),
            12.0 * n + 16.0 * n + 4.0 * (n // tl), 24.0 * n + 40.0 * nv,
            path=path, counter="fused_sorted_voxel_reduce_quantized")

    (cols, keep), _ = captured["compact"]
    compaction_row(rows, list(cols), keep, "blockwise_compact_distributed",
                   path, flush)

    (sp, pp, k, w), _ = captured["window_fit"]
    got = wf.window_fit_moments(sp, pp, k, w)
    want = wf.window_fit_moments_plain(sp, pp, k, w)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want)):
        raise AssertionError(f"window_fit_moments on distributed_normals' "
                             f"inputs differs by {err}")
    nq = sp.shape[0]
    selected = float(got[0].sum().item())
    add_row(rows, "window_fit_moments_distributed", _CSRC + "window_fit.cu",
            _TPU + "window_fit_kernel.py:214", err,
            gpu_ms(lambda: wf.window_fit_moments(sp, pp, k, w), flush),
            gpu_ms(lambda: wf.window_fit_moments_plain(sp, pp, k, w), flush,
                   warmup=1, reps=3),
            68.0 * nq + 24.0 * w,
            nq * ((2.0 * w + 1) * 10 + 2.0 * k * k) + 20.0 * selected,
            path=path, counter="window_fit_moments")


def world_line(world: list, name: str, gates: dict, smi: str) -> dict:
    """The phase's line for one world: rank 0's seconds, launches and
    collectives per step, the slowest rank's seconds, host staging, build
    seconds per rank, device busy on rank 0, the gates' readings."""
    r0 = world[0]
    steps = list(r0["seconds"])
    return {
        "phase": "path_distributed", "world": name, "ranks": len(world),
        "backend": r0["backend"],
        "seconds": r0["seconds"],
        "seconds_slowest_rank": {s: max(r["seconds"][s] for r in world)
                                 for s in steps},
        "launches_rank0": r0["launches"],
        "collective_bytes": {s: {c: v["bytes"] for c, v in
                                 r0["collectives"][s].items()
                                 if c != "staged"} for s in steps},
        "collective_calls": {s: sum(v["calls"] for c, v in
                                    r0["collectives"][s].items()
                                    if c != "staged") for s in steps},
        "staged_bytes": {s: sum(r0["collectives"][s]["staged"].values())
                         for s in steps},
        "build_seconds": [r.get("build_s") for r in world],
        "device_busy_rank0": r0.get("busy"),
        "cross_cpu": [r.get("cross_cpu") for r in world],
        "gates": gates, "card": smi}


def mesh2d_line(world: list, cfg: dict, gates: dict, smi: str) -> dict:
    """The phase's line for world (b)'s 2-D mesh: rank 0's seconds a step
    and the slowest rank's, the seconds of all its steps, collective and
    staged bytes a step on rank 0, rank 0's device busy over the
    millisecond steps, the gates' readings (the kernel holds among
    them)."""
    recs = [r["mesh2d"] for r in world]
    r0 = recs[0]
    steps = list(r0["seconds"])
    busy = r0.get("busy")
    return {
        "phase": "path_distributed", "world": f"b: {len(world)} ranks as a "
        f"{tuple(cfg['mesh2d'])} {MESH2D_AXES} mesh, steps over points",
        "mesh_seconds": [rec["mesh_s"] for rec in recs],
        "wall_seconds_slowest_rank": max(rec["wall_s"] for rec in recs),
        "seconds": r0["seconds"],
        "seconds_slowest_rank": {s: max(rec["seconds"][s] for rec in recs)
                                 for s in steps},
        "step_seconds_total": sum(r0["seconds"].values()),
        "launches_rank0": r0["launches"],
        "collective_bytes": {s: sum(v["bytes"] for c, v in
                                    r0["collectives"][s].items()
                                    if c != "staged") for s in steps},
        "staged_bytes": {s: sum(r0["collectives"][s]["staged"].values())
                         for s in steps},
        "device_busy_rank0": busy, "device_busy_share_rank0": (
            busy["busy_ms"] / busy["traced_ms"] if busy else None),
        "gates": gates, "card": smi}


def phase_path_distributed(rows: list, smi: str, wbatch: PointBatch,
                           surface: np.ndarray) -> None:
    """The distributed layer on the card, twice: (a) a one-rank NCCL world
    in this process, (b) ``DIST_SIZE`` spawned ranks sharing the card on
    gloo (host staging counted); both at the single-card paths' sizes,
    every step gated against the single-device path
    (:func:`gate_distributed`), (b) against (a) (:func:`compare_worlds`),
    and the kernels of the path held against their plain versions on
    world (a)'s inputs (:func:`distributed_rows`)."""
    t_phase = time.perf_counter()
    work = Path(__file__).resolve().parent / DIST_DIR
    cfg = dist_config()
    try:
        t0 = time.perf_counter()
        refs = prepare_distributed(work, cfg, wbatch, surface)
        prep_s = time.perf_counter() - t0
        captured = {}
        t0 = time.perf_counter()
        parallel.initialize_multihost(f"localhost:{par_spawn.free_port()}",
                                      1, 0)
        try:
            a = [distributed_world(0, 1, str(work), cfg, capture=captured)]
        finally:
            dist.destroy_process_group()
        world_a_s = time.perf_counter() - t0
        gates_a = gate_distributed(a, refs, cfg)
        distributed_rows(rows, captured)
        # a row's launches: one call of every step of world (a), each read
        # from counts set to 0 just before it and read just after
        read_launches(rows, "path_distributed", {
            c: sum(v[c] for v in a[0]["launches"].values())
            for c in DIST_COUNTERS})
        del captured
        print(json.dumps(world_line(a, "a: one-rank NCCL", gates_a, smi)),
              flush=True)
        t0 = time.perf_counter()
        b = par_spawn.run_world(
            distributed_world, DIST_SIZE, (str(work),
                                           {**cfg, "backend": "gloo"}),
            device="cuda", backend="gloo", timeout_s=600.0)
        world_b_s = time.perf_counter() - t0
        gates_b = gate_distributed(b, refs, cfg)
        print(json.dumps(world_line(b, f"b: {DIST_SIZE} ranks sharing the "
                                       f"card, gloo", gates_b, smi)),
              flush=True)
        gates_2d = gate_mesh2d(b, refs, cfg)
        print(json.dumps(mesh2d_line(b, cfg, gates_2d, smi)), flush=True)
        agree = compare_worlds(a, b)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({
        "phase": "path_distributed", "worlds_agree": agree,
        "prepare_seconds": prep_s, "prepare_split": refs["seconds"],
        "world_a_wall_seconds": world_a_s,
        "world_b_wall_seconds": world_b_s,
        "seconds": time.perf_counter() - t_phase,
        "icp_points": refs["icp_points"], "card": smi}), flush=True)


def cg_iteration_ms(graph) -> float:
    """GPU time of one PCG iteration of the pose graph, its host read of
    r·z included: one Gauss-Newton step with 64 CG iterations forced (a
    zero tolerance never exits early) minus one with none."""
    def run(cg_iterations):
        return lambda i: optimize_pose_graph(graph, iterations=1,
                                             solver="cg",
                                             cg_iterations=cg_iterations,
                                             cg_tol=0.0)
    with_cg = step_ms(run(64), warmup=1, reps=3)[0]
    return (with_cg - step_ms(run(0), warmup=1, reps=3)[0]) / 64


def main() -> int:
    t0 = time.perf_counter()
    dev = resolve_device(None)          # raises without a CUDA device
    info = phase_device()
    phase_build()
    phase_tile_sort_sweep(dev)
    phase_window_fit_sweep(dev)
    affine = affine_on(dev)
    phase_voxel_reduce_sweep(dev, affine)
    phase_compact_sweep(dev)
    phase_world_bounds_sweep(dev, affine)
    tiles = ZTILES * XTILES
    local_np, inten_np, cls_np = make_columns(N)
    batch = make_batch(local_np, inten_np, cls_np, device=dev)
    rows = phase_kernels(batch, affine, tiles)
    print(json.dumps({"phase": "kernels", "points": N, "tiles": tiles,
                      "names": [r["name"] for r in rows]}), flush=True)
    smi = info["nvidia_smi"]
    phase_main_path(batch, affine, local_np, tiles, rows, smi)
    # the f32 world positions of the batch, for the two paths that start
    # from a position column
    wbatch = attribute_batch(batch, exact_f32_head(batch, affine)[1])
    phase_path_filter_grid(wbatch, rows, smi)
    phase_path_quantized(batch, wbatch, affine, tiles, rows, smi)
    phase_path_exact_f32(batch, affine, tiles, rows, smi)
    surface = normals_surface()
    phase_path_normals(surface, rows, smi)
    src, tgt = phase_path_icp(dev, rows, smi)
    phase_path_registration(smi)
    at_scale = time.perf_counter()
    phase_path_normals_exact(smi)
    phase_path_pose_graph(smi)
    phase_path_trajectory(rows, smi)
    at_scale = time.perf_counter() - at_scale
    phase_path_concat_convert(smi)
    phase_path_file_to_map(rows, smi)
    phase_path_formats(rows, smi)
    plane = phase_path_segmentation(smi)
    phase_path_hull(smi)
    phase_path_reproject(smi)
    phase_path_distributed(rows, smi, wbatch, surface)
    if "--profile" in sys.argv[1:]:
        def shift(i):
            return (i % 7) * 1e-6
        phase_call_split(batch, affine, tiles, smi)
        phase_profile("main_path", lambda i: pipeline_batch(
            batch, affine, tiles, shift=shift(i)))
        phase_profile("path_filter_grid", lambda i: path_filter_grid(wbatch),
                      steps=3)
        phase_profile("path_quantized", lambda i: path_quantized(
            batch, quantized_head(batch, affine, shift(i)), tiles))
        phase_profile("path_exact_f32", lambda i: path_exact_f32(
            batch, exact_f32_head(batch, affine, shift(i)), tiles))
        buf = positions_buffer(surface)
        phase_profile("path_normals", lambda i: path_normals(buf), steps=3)
        # three iterations of point-to-plane ICP, target normals included
        phase_profile("path_icp", lambda i: path_icp(src, tgt, True, 3),
                      steps=1)
        phase_profile("path_segmentation", lambda i: ransac(
            plane, 3, SEG_PLANE_ITERS, 1), steps=2)
    print(json.dumps({"phase": "total",
                      "seconds": time.perf_counter() - t0,
                      "at_scale_phases_seconds": at_scale}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
