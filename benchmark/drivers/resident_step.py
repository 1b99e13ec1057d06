"""Driver: the tiled exact-local voxel step on a tile resident on the card.

Set-up makes the survey tile on the card from the seed and cuts its
Morton order into the aligned squares that one step's 10-bit grid reaches
(1024 leaves a side).  Each square is one batch: its int32 LAS locals,
intensity and classification, padded to whole tiles of ``tile_rows``
rows.  One unit is one step of the program's main path on the next batch,
around and around: K1 world bounds of the batch's points, the grid anchor
(the minimum floored to a whole leaf), the base coefficients, K2 the
exact-local head, then ``voxel_downsample(precomputed=, local_affine=,
sort_tiles=)`` (K4, K3), whose defined output is one row per (tile,
voxel).  The step maps the locals into the file's frame: the LAS scale,
no rotation, the LAS offset as the translation.  Set-up runs one step on
every batch (every shape warmed).
"""

from __future__ import annotations

import time

import numpy as np
import torch

import harness
import roofline
from reference import compare, voxel_map
from scenes import ahn4


class Driver:
    def __init__(self, config, traffic, seed, device, workdir):
        from pasture_tpu_torch.buffers.device import PointBatch
        from pasture_tpu_torch.layout import attributes as att
        from pasture_tpu_torch.layout.schema import PointSchema
        from pasture_tpu_torch.ops import kernels
        from pasture_tpu_torch.ops.voxel import voxel_downsample

        self.kernels, self.voxel_downsample = kernels, voxel_downsample
        self.att = att
        self.device = dev = torch.device(device)
        self.config, self.traffic = config, traffic
        leaf, rows = traffic["leaf"], traffic["tile_rows"]
        self.leaf, self.rows = leaf, rows
        t0 = time.perf_counter()
        tile = ahn4.make_tile(config, seed, dev)
        t1 = time.perf_counter()
        block_mm = round((1 << traffic["grid_bits"]) * leaf
                         / config["scale"][0])
        schema = PointSchema.from_attributes(
            [att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION])
        self.batches = []
        for start, n in ahn4.block_runs(tile["local"], block_mm):
            cap = -(-n // rows) * rows
            local = torch.zeros((cap, 3), dtype=torch.int32, device=dev)
            inten = torch.zeros(cap, dtype=torch.int32, device=dev)
            cls = torch.zeros(cap, dtype=torch.uint8, device=dev)
            local[:n] = tile["local"][start:start + n]
            inten[:n] = tile["intensity"][start:start + n]
            cls[:n] = tile["classification"][start:start + n]
            batch = PointBatch(
                {att.INTENSITY.name: inten, att.CLASSIFICATION.name: cls},
                torch.tensor(n, dtype=torch.int32, device=dev), schema, {})
            self.batches.append({"n": n, "cap": cap, "local": local,
                                 "batch": batch,
                                 "bytes": roofline.step_bytes(n, cap)})
        del tile
        # the file's frame: the LAS scale, no rotation, the LAS offset as
        # the translation, so the step's map is in the survey's coordinates
        self.scale_np = np.asarray(config["scale"], np.float32)
        self.affine = (torch.tensor(self.scale_np, device=dev),
                       torch.eye(3, dtype=torch.float32, device=dev),
                       torch.tensor(config["offset"], dtype=torch.float32,
                                    device=dev))
        self.sample = harness.Reservoir(traffic["checked_units"], seed)
        t2 = time.perf_counter()
        for b in range(len(self.batches)):
            self.step(b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.phases = {"generate_s": t1 - t0, "batches_s": t2 - t1,
                       "warm_s": time.perf_counter() - t2}

    def step(self, b):
        k = self.kernels
        d = self.batches[b]
        scale, rot, t = self.affine
        wmin, _ = k.fused_world_bounds(d["local"][:d["n"]], scale, rot, t)
        bmin = torch.floor(wmin / self.leaf) * self.leaf
        coeffs = k.exact_local_base_coeffs(self.scale_np, rot, t, bmin,
                                           self.leaf, "floor")
        keys, rword = k.fused_voxel_head_exact_local(
            d["local"], scale, rot, t, bmin, self.leaf, coeffs,
            semantics="floor")
        return self.voxel_downsample(
            d["batch"], self.leaf, bounds=(bmin, None), semantics="floor",
            grid_bits=10, sort_tiles=d["cap"] // self.rows,
            precomputed=(keys, rword), local_affine=(scale, rot, t, coeffs))

    def unit(self, i):
        b = i % len(self.batches)
        out = self.step(b)
        self.sample.offer((b, out))
        d = self.batches[b]
        return {"points": d["n"], "steps": 1, "roofline_bytes": d["bytes"]}

    def counters(self):
        return {}

    def info(self):
        return {"setup_phases": self.phases}

    def _as_map(self, out):
        a = self.att
        nv = int(out.count)
        return {"centroid": out.data[a.POSITION_3D.name][:nv].to(
                    torch.float64),
                "intensity": out.data[a.INTENSITY.name][:nv].to(torch.int64),
                "classification": out.data[a.CLASSIFICATION.name][:nv].to(
                    torch.int64)}

    def release(self):
        self.kept = [(b, self._as_map(o)) for b, o in self.sample.items]
        self.sample.items = []

    def _reference(self, b, precision="float32"):
        d = self.batches[b]
        n = d["n"]
        return voxel_map.tiled_step_map(
            d["local"][:n], d["batch"].data[self.att.INTENSITY.name][:n],
            d["batch"].data[self.att.CLASSIFICATION.name][:n],
            self.config["scale"], self.config["offset"], self.leaf,
            self.rows, precision)

    def check(self, control):
        if control:
            pairs = [(b, self._reference(b, "bfloat16"))
                     for b in range(len(self.batches))]
        else:
            pairs = self.kept
        refs = {}
        readings = []
        for b, got in pairs:
            if b not in refs:
                refs[b] = self._reference(b)
            readings.append(compare.rows(got, refs[b]))
        return compare.worst(readings, self.traffic["limits"])

    def close(self):
        self.batches = []
