"""Distributed pipeline: sharded ingest -> Morton partition -> voxelize ->
ICP -> normals, over a mesh of ranks.

Port of examples/distributed_registration.py to pasture_tpu_torch: the
JAX package runs one program over a device mesh; the port runs one
process a rank (``parallel.spawn.run_world`` starts them on this machine
and joins them into one ``torch.distributed`` world), each holding its own
shard.  ``--ranks`` ranks (default 4); with ``--device cpu`` they meet on
gloo, on the card each rank takes a card of its own (``cuda:<rank>``)
and NCCL.

Usage: python examples/torch/distributed_registration.py [--ranks 4]
       [--device cpu]
"""

import argparse

import numpy as np
import torch

from pasture_tpu_torch.buffers.device import PointBatch
from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.parallel import (
    distributed_icp,
    distributed_icp_partitioned,
    distributed_normals,
    global_mesh,
    morton_partition,
    shard_batch,
    sharded_bounds,
    sharded_voxel_downsample,
    sharded_voxel_downsample_merged,
)
from pasture_tpu_torch.parallel.spawn import run_world


def rank_main(rank, size, device):
    """One rank's part of the example; what it prints is rank 0's."""
    say = print if rank == 0 else (lambda *a, **k: None)
    if device is None:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    mesh = global_mesh(device=device)
    say(f"mesh: {size} ranks over ('points',)")

    rng = np.random.default_rng(0)
    n = 4096 * size
    pos = rng.uniform(0, 50, (n, 3))
    schema = PointSchema.from_attributes([att.POSITION_3D])
    host = HostPointBuffer.from_columns(schema, {att.POSITION_3D.name: pos})
    batch = shard_batch(PointBatch.from_host(host, capacity=n, device="cpu"),
                        mesh)

    mn, mx = sharded_bounds(batch, mesh)
    say("global bounds:", mn.cpu().numpy(), mx.cpu().numpy())

    part, counts, dropped = morton_partition(batch, mesh)
    assert int(dropped.sum()) == 0, "raise capacity_factor"
    say("points per rank after Morton partition:", counts.cpu().numpy())

    vox, vcounts = sharded_voxel_downsample(part, mesh, 1.0,
                                            per_shard_counts=counts)
    say("voxels per rank:", vcounts.cpu().numpy(), "total:", int(vox.count))

    # exact global merge: per-shard partials carry counts and unrounded
    # means, and the weighted merge reproduces the one-shot single-device
    # voxelization (mode_runs=True makes the mode policy's merge exact too)
    merged, aux = sharded_voxel_downsample_merged(
        part, mesh, 1.0, per_shard_counts=counts)
    say("globally merged voxels:", int(merged.count),
        "(points accounted:", int(aux["counts"].sum()), ")")

    # scan-to-map ICP, replicated map: the same cloud shifted; this rank
    # holds its block of the source
    target = torch.from_numpy(pos.astype(np.float32)).to(device)
    source = target - torch.tensor([0.4, -0.2, 0.1], device=device)
    per = n // size
    result = distributed_icp(source[rank * per:(rank + 1) * per], target,
                             mesh, max_correspondence_distance=2.0,
                             iterations=10)
    t = result.translation.cpu().numpy()
    say("recovered translation:", np.round(t, 4), "rmse:", float(result.rmse))

    # scan-to-map ICP with the map partitioned (never replicated): the scan
    # co-partitions with the map's Morton splitters and matches against
    # its local block and the ring neighbours' halo rows
    src_host = HostPointBuffer.from_columns(
        schema, {att.POSITION_3D.name: source.cpu().numpy()})
    src_batch = shard_batch(PointBatch.from_host(src_host, capacity=n,
                                                 device="cpu"), mesh)
    result_p, dropped_p = distributed_icp_partitioned(
        src_batch, batch, mesh, halo=256, capacity_factor=4.0,
        max_correspondence_distance=2.0, iterations=10)
    assert int(dropped_p) == 0
    t_p = result_p.translation.cpu().numpy()
    say("partitioned-map translation:", np.round(t_p, 4))

    # halo-windowed normals over the partitioned cloud
    _, normals, curvature, ncounts, ndropped = distributed_normals(
        batch, mesh, k=10, window=32, capacity_factor=4.0)
    assert int(ndropped.sum()) == 0
    say("normals computed per rank:", ncounts.cpu().numpy())
    return {"translation": t, "partitioned_translation": t_p,
            "voxels": int(merged.count), "normals": ncounts.cpu().numpy()}


def main(ranks=4, device=None):
    """Run the example in a fresh world of ``ranks`` ranks; returns each
    rank's summary."""
    return run_world(rank_main, ranks, (device,), device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="torch device (default: a GPU a rank)")
    args = parser.parse_args()
    main(args.ranks, args.device)
