"""Driver: a block of LAS sub-tiles folded into one map, one sub-tile a rank.

A cell on several cards (``world.py``): rank ``r`` of ``n`` makes the
sub-tiles ``i`` with ``i % n == r`` on its card, each from the seed and its
own index (so a sub-tile's points do not depend on the number of ranks),
and writes each with the benchmark's LAS writer into one directory that
rank 0 made and named to the others.  Then one warm fold.

One unit is one fold of the whole block by the program's public entry
points, on every rank in lockstep: ``sharded_read_all`` of every sub-tile
(each rank decodes its own rows), then ``sharded_voxel_downsample_merged``
on ``global_mesh()`` (stage-1 voxelize, all-gather, exact merge), which
leaves the merged map on every rank.  Folds whose maps the check compares
are drawn from the seed, the same on every rank.

The check: every rank's kept maps by checksum against rank 0's, then rank 0
holds its maps to the plain reference's map of the whole block, the
sub-tiles made again from the seed in the block's frame.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from lasfile import write_las
from reference import compare, voxel_map
from scenes import ahn4
import harness

#: seconds the driver's own collectives (on the CPU) may wait
TIMEOUT_S = 300.0


def sub_tile_seed(seed: int, index: int) -> int:
    """The seed of sub-tile ``index`` of a block made from ``seed``."""
    return (int(seed) + (index + 1) * 0x9E3779B97F4A7C15) % (1 << 63)


def sub_tile_config(config, index: int):
    """The scene generator's configuration of one sub-tile: the block's
    keys, the sub-tile's south-west corner as its LAS offset."""
    x, y = config["sub_tiles"][index]
    return dict(config, offset=[float(x), float(y), 0.0])


def block_locals(config, index: int, local: torch.Tensor) -> torch.Tensor:
    """A sub-tile's integer locals in the block's frame (the block's
    offset), shifted by whole scale steps."""
    x, y = config["sub_tiles"][index]
    bx, by, _ = config["offset"]
    shift = [round((x - bx) / config["scale"][0]),
             round((y - by) / config["scale"][1]), 0]
    return local + torch.tensor(shift, dtype=local.dtype,
                                device=local.device)


def checksum(m) -> list:
    """A map's checksum: its row count and, per column, the wrapping sum
    of its 64-bit words times their positions (centroids by their bits)."""
    n = int(m["key"].shape[0])
    w = torch.arange(1, n + 1, dtype=torch.int64, device=m["key"].device) \
        * 0x9E3779B1 + 0x7F4A7C15
    cols = [m["key"], m["counts"], m["intensity"], m["classification"]] \
        + [m["centroid"][:, a].contiguous().view(torch.int64)
           for a in range(3)]
    return [n] + [int((c.to(torch.int64) * w).sum()) for c in cols]


class Driver:
    def __init__(self, config, traffic, seed, device, workdir):
        from pasture_tpu_torch import parallel
        from pasture_tpu_torch.layout import attributes as att
        from pasture_tpu_torch.layout.schema import PointSchema

        self.parallel, self.att = parallel, att
        self.device = torch.device(device)
        self.config, self.traffic, self.seed = config, traffic, seed
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        # the driver's own bookkeeping (the directory's name, the
        # checksums) on the CPU, off the cards' streams
        self.book = dist.new_group(backend="gloo",
                                   timeout=timedelta(seconds=TIMEOUT_S))
        self.mesh = parallel.global_mesh(device=self.device)
        name = [tempfile.mkdtemp(prefix="bench-sheet-")] \
            if self.rank == 0 else [None]
        dist.broadcast_object_list(name, src=0, group=self.book)
        self.dir = name[0]
        tiles = len(config["sub_tiles"])
        self.paths = [os.path.join(self.dir, f"sub-tile-{i}.las")
                      for i in range(tiles)]
        t0 = time.perf_counter()
        gen = write = 0.0
        for i in range(self.rank, tiles, self.size):
            a = time.perf_counter()
            t = ahn4.make_tile(sub_tile_config(config, i),
                               sub_tile_seed(seed, i), self.device)
            b = time.perf_counter()
            write_las(self.paths[i], t["local"].cpu().numpy(),
                      t["intensity"].cpu().numpy(),
                      t["classification"].cpu().numpy(),
                      scale=config["scale"],
                      offset=sub_tile_config(config, i)["offset"])
            gen += b - a
            write += time.perf_counter() - b
            del t
        dist.barrier(group=self.book)
        t1 = time.perf_counter()
        self.schema = PointSchema.from_attributes(
            [att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION])
        self.sample = harness.Reservoir(traffic["checked_units"], seed)
        self.last = None
        out = self.fold()              # warm: every shape the window uses
        self.points = int(out[1]["counts"].sum())
        del out
        self.warm, self.folds = self.counters(), 0
        self.phases = {"generate_s": gen, "write_s": write,
                       "files_s": t1 - t0,
                       "warm_s": time.perf_counter() - t1}

    def fold(self):
        p, tr = self.parallel, self.traffic
        batch = p.sharded_read_all(self.paths, self.mesh, schema=self.schema,
                                   capacity_multiple=tr["tile_rows"])
        return p.sharded_voxel_downsample_merged(
            batch, self.mesh, tr["leaf"], grid_bits=tr["grid_bits"],
            mode_runs=tr["mode_runs"],
            sort_tiles=batch.capacity // tr["tile_rows"])

    def unit(self, i):
        batch, aux = self.fold()
        self.folds += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # what the check reads, and nothing more: the run tables go
        kept = (batch.data, batch.count, aux["keys"], aux["counts"])
        self.sample.offer(kept)
        self.last = kept
        return {"points": self.points, "folds": 1}

    def counters(self):
        p = self.parallel
        out = {"all_gather_bytes":
               p.collective_counts()["all_gather"]["bytes"]}
        decoded = getattr(p, "POINTS_DECODED", None)
        if decoded is not None:
            out["points_decoded"] = decoded["sharded_read_all"]
        spans = getattr(p, "span_seconds", None)
        if spans is not None:
            out.update({f"span_{k}_s": v for k, v in spans().items()})
        return out

    def info(self):
        """The set-up's phases, and each rank's points decoded and phase
        milliseconds a fold over the folds after the warm one."""
        c = {k: (v - self.warm[k]) / max(self.folds, 1)
             for k, v in self.counters().items()}
        mine = {"points_decoded": c.get("points_decoded"),
                **{k[5:-2]: round(1e3 * v, 3)
                   for k, v in c.items() if k.startswith("span_")}}
        every = [None] * self.size
        dist.all_gather_object(every, mine, group=self.book)
        return {"setup_phases": self.phases,
                "ranks_per_fold": every}

    def _as_map(self, kept):
        """The program's map as the comparison takes it: cells decoded
        from its keys by the reference's own decoder, rows by cell."""
        data, count, (hi, lo), counts = kept
        nv = int(count)
        cell = voxel_map.cells_of_morton60(hi[:nv], lo[:nv])
        key = voxel_map.linear_code(cell)
        order = torch.argsort(key)
        a = self.att
        return {"key": key[order],
                "counts": counts[:nv].to(torch.int64)[order],
                "centroid": data[a.POSITION_3D.name][:nv].to(
                    torch.float64)[order],
                "intensity": data[a.INTENSITY.name][:nv].to(
                    torch.int64)[order],
                "classification": data[a.CLASSIFICATION.name][:nv].to(
                    torch.int64)[order]}

    def release(self):
        kept = list(self.sample.items)
        if self.last is not None and all(k is not self.last for k in kept):
            kept.append(self.last)
        self.sample.items, self.last = [], None
        self.maps, self.sums = [], []
        for k in kept:
            m = self._as_map(k)
            self.sums.append(checksum(m))
            if self.rank == 0:
                self.maps.append(m)

    def block(self):
        """The whole block made again from the seed, in the block's frame:
        ``(local, intensity, classification)``."""
        parts = []
        for i in range(len(self.config["sub_tiles"])):
            t = ahn4.make_tile(sub_tile_config(self.config, i),
                               sub_tile_seed(self.seed, i), self.device)
            parts.append((block_locals(self.config, i, t["local"]),
                          t["intensity"], t["classification"]))
        return tuple(torch.cat(c) for c in zip(*parts))

    def check(self, control):
        sums = [] if control else self.sums
        every = [None] * self.size if self.rank == 0 else None
        dist.gather_object(sums, every, dst=0, group=self.book)
        if self.rank != 0:
            return {}, 0
        differing = sum(s != every[0] for s in every[1:])
        args = (*self.block(), self.config["scale"], self.config["offset"],
                self.traffic["leaf"], self.traffic["grid_bits"])
        ref = voxel_map.fold_map(*args)
        got = [voxel_map.fold_map(*args, precision="bfloat16")] if control \
            else self.maps
        return compare.worst([dict(compare.keyed(g, ref),
                                   ranks_differing=float(differing))
                              for g in got], self.traffic["limits"])

    def close(self):
        for i in range(self.rank, len(self.paths), self.size):
            with contextlib.suppress(FileNotFoundError):
                os.remove(self.paths[i])
        if self.rank == 0:
            shutil.rmtree(self.dir, ignore_errors=True)
