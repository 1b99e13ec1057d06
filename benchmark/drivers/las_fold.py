"""Driver: whole LAS files folded into a voxel map, again and again.

Set-up makes the survey tile on the card from the seed, writes it with the
benchmark's own LAS writer into the run's temporary directory and folds it
once (every shape of the fold, and the program's kernel and codec builds).
One unit is one fold of the whole file by the program's
``streaming_voxel_downsample``, with the traffic file's arguments: read,
upload, per-chunk voxelize, merge.  Folds whose maps the check compares
are drawn from the seed as the window runs.
"""

from __future__ import annotations

import math
import os
import time

import torch

from lasfile import write_las
from reference import compare, voxel_map
from scenes import ahn4
import harness


class Driver:
    def __init__(self, config, traffic, seed, device, workdir):
        from pasture_tpu_torch.io import streaming
        from pasture_tpu_torch.layout import attributes as att
        from pasture_tpu_torch.layout.schema import PointSchema

        self.streaming = streaming
        self.att = att
        self.device = torch.device(device)
        self.config, self.traffic = config, traffic
        t0 = time.perf_counter()
        self.tile = ahn4.make_tile(config, seed, self.device)
        t1 = time.perf_counter()
        self.n = int(self.tile["local"].shape[0])
        self.path = os.path.join(workdir, "tile.las")
        write_las(self.path, self.tile["local"].cpu().numpy(),
                  self.tile["intensity"].cpu().numpy(),
                  self.tile["classification"].cpu().numpy(),
                  scale=config["scale"], offset=config["offset"])
        t2 = time.perf_counter()
        chunk = traffic["chunk_points"]
        self.chunks = math.ceil(self.n / chunk)
        self.kw = dict(chunk_points=chunk, grid_bits=traffic["grid_bits"],
                       use_metadata_bounds=True,
                       sort_tiles=chunk // traffic["tile_rows"],
                       schema=PointSchema.from_attributes(
                           [att.POSITION_3D, att.INTENSITY,
                            att.CLASSIFICATION]),
                       device=self.device, with_aux=True,
                       mode_runs=traffic["mode_runs"])
        self.sample = harness.Reservoir(traffic["checked_units"], seed)
        self.fold()                    # warm: every shape the window uses
        self.last = None
        self.phases = {"generate_s": t1 - t0, "write_s": t2 - t1,
                       "warm_s": time.perf_counter() - t2}

    def fold(self):
        return self.streaming.streaming_voxel_downsample(
            self.path, self.traffic["leaf"], **self.kw)

    def unit(self, i):
        out = self.fold()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.sample.offer(out)
        self.last = out
        return {"points": self.n, "chunks": self.chunks, "folds": 1}

    def counters(self):
        return {"host_syncs": self.streaming.HOST_SYNCS[
            "streaming_voxel_downsample"]}

    def info(self):
        return {"setup_phases": self.phases}

    def _as_map(self, out):
        """The program's map as the comparison takes it: cells decoded
        from its keys by the reference's own decoder, rows by cell."""
        batch, aux = out
        nv = int(batch.count)
        hi, lo = aux["keys"]
        cell = voxel_map.cells_of_morton60(hi[:nv], lo[:nv])
        key = voxel_map.linear_code(cell)
        order = torch.argsort(key)
        a = self.att
        return {"key": key[order],
                "counts": aux["counts"][:nv].to(torch.int64)[order],
                "centroid": batch.data[a.POSITION_3D.name][:nv].to(
                    torch.float64)[order],
                "intensity": batch.data[a.INTENSITY.name][:nv].to(
                    torch.int64)[order],
                "classification": batch.data[a.CLASSIFICATION.name][:nv].to(
                    torch.int64)[order]}

    def release(self):
        kept = list(self.sample.items)
        if self.last is not None and all(k is not self.last for k in kept):
            kept.append(self.last)
        self.maps = [self._as_map(o) for o in kept]
        self.sample.items = []
        self.last = None

    def check(self, control):
        t = self.tile
        args = (t["local"], t["intensity"], t["classification"],
                self.config["scale"], self.config["offset"],
                self.traffic["leaf"], self.traffic["grid_bits"])
        ref = voxel_map.fold_map(*args)
        got = [voxel_map.fold_map(*args, precision="bfloat16")] if control \
            else self.maps
        return compare.worst([compare.keyed(g, ref) for g in got],
                             self.traffic["limits"])

    def close(self):
        if os.path.exists(self.path):
            os.remove(self.path)
