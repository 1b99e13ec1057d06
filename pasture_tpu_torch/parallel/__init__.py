"""Distributed layer on ``torch.distributed``: meshes of ranks, sharded
batches, spatial partitioning, halo exchange and distributed registration.

Port of pasture_tpu/parallel.  The JAX package runs one program over a
device mesh (``shard_map`` with ``psum`` / ``all_to_all`` / ``ppermute``);
the port runs one process per device, each holding only its own shard, and
meets the other ranks in the collectives of :mod:`._comm` (NCCL on the
card, gloo on the CPU, gloo through host memory for ranks that share one
card).  A mesh has any number of axes (``make_mesh(n, axes, shape)``);
every op shards over its ``axis=`` and meets the other ranks on that
axis's line through it, replicated over the other axes.  Replicated
results (bounds, poses, merged voxels) are the same on every rank;
per-shard counts come back as tensors of the axis's length, the same on
every rank.  ``parallel.spawn`` starts a world of local processes.
"""

from ._comm import collective_counts, reset_collective_counts  # noqa: F401
from .mesh import (Mesh, batch_sharding, make_mesh,  # noqa: F401
                   shard_batch)
from .ops import sharded_bounds, sharded_voxel_downsample, \
    sharded_voxel_downsample_merged, \
    distributed_normals  # noqa: F401
from .partition import morton_partition, MortonPartitionSpec  # noqa: F401
from .distributed import distributed_icp, distributed_icp_partitioned, \
    distributed_pose_graph  # noqa: F401
from .halo import halo_exchange, halo_exchange_local  # noqa: F401
from .ingest import sharded_read_all  # noqa: F401
from .multihost import initialize_multihost, global_mesh  # noqa: F401
