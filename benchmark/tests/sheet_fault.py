"""The sheet fold's driver with one fault planted under its timed path on
one rank, for ``test_bench_sheet.py`` only (copied into a copy of the
benchmark as ``drivers/sheet_fault.py``; never a driver of a cell).

``traffic["fault"] = {"kind": k, "rank": r}``, on rank ``r``:

* ``half_left_out`` — the rank's stage-1 voxelize sees half of its shard;
* ``map_altered`` — the rank's merged map has one centroid moved 0.25 m;
* ``rank_differs`` — the same, on a rank other than 0, whose map the
  comparison with the reference never reads.
"""

from __future__ import annotations

import torch.distributed as dist

import harness

_real = harness.load_module("drivers", "sheet_fold")


def _plant(kind: str) -> None:
    import pasture_tpu_torch.parallel as parallel
    import pasture_tpu_torch.parallel.ops as ops
    if kind == "half_left_out":
        real = ops.voxel_downsample
        ops.voxel_downsample = lambda b, *a, **kw: real(
            b.with_count(b.count // 2), *a, **kw)
        return
    real = parallel.sharded_voxel_downsample_merged

    def altered(*a, **kw):
        batch, aux = real(*a, **kw)
        batch.data["Position3D"][0, 0] += 0.25
        return batch, aux
    parallel.sharded_voxel_downsample_merged = altered


class Driver(_real.Driver):
    def __init__(self, config, traffic, seed, device, workdir):
        fault = traffic["fault"]
        if dist.get_rank() == fault["rank"]:
            _plant(fault["kind"])
        super().__init__(config, traffic, seed, device, workdir)
