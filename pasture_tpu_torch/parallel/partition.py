"""Morton-keyed spatial repartitioning across the mesh.

Port of pasture_tpu/parallel/partition.py.  ``morton_partition``
redistributes a batch sharded over a mesh axis so the shard at coordinate
``d`` of the axis owns the ``d``-th contiguous range of the global Morton
curve; every collective runs on the axis's line through the rank, so the
partition is replicated over the other axes:

1. per rank: Morton keys on a globally agreed isotropic grid (the ranks'
   ``min`` / ``max`` bounds, one all-reduce);
2. a 4 096-bucket histogram over the keys' top bits, summed over the mesh
   -> equal-mass splitters;
3. one ``all_to_all`` of a fixed ``slot`` rows per (source, destination)
   pair; rows that do not fit are dropped and counted, never silently.

Each step keeps the reference's arithmetic, so a rank's rows equal the
reference's shard bit for bit: the same splitters, the same stable order
by destination, the same ``slot``, received blocks compacted in source
order, and ``sort_local`` as one stable sort of ``hi << 30 | lo`` (the
reference's two stable argsorts, lo then hi).  The sends and the
compaction are gathers (no scatter), and the columns and counts cross in
one packed exchange.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..buffers.device import PointBatch
from ..layout import attributes as att
from ..math.morton import morton_encode_dual32
from ..ops.reductions import batch_bounds
from . import _comm
from .mesh import POINTS_AXIS, Mesh

__all__ = ["morton_partition", "MortonPartitionSpec"]

_HIST_BITS = 12  # histogram over the top 12 Morton bits (4096 buckets)
_INVALID = 0xFFFFFFFF


class MortonPartitionSpec(NamedTuple):
    """The splitters of one partition run, the same on every rank: the
    global grid (``gmin``, ``extent``) and the bucket -> rank map.  Pass it
    back into :func:`morton_partition` to co-partition a second cloud onto
    the same Morton ranges (scan-to-map)."""

    gmin: torch.Tensor            # (3,) — global grid origin
    extent: torch.Tensor          # (3,) — isotropic grid extent
    dest_of_bucket: torch.Tensor  # (4096,) int64 — bucket -> rank


def _morton_hi_bucket(pos: torch.Tensor, mask: torch.Tensor,
                      gmin: torch.Tensor, extent: torch.Tensor):
    """Bucket of each row from the top ``_HIST_BITS`` of its (hi, lo)
    Morton key (invalid rows: the last bucket), and the key words."""
    cell = torch.clamp((pos - gmin[None, :]) / extent[None, :] * (1 << 20),
                       0, (1 << 20) - 1).to(torch.int32)
    hi, lo = morton_encode_dual32(cell[:, 0], cell[:, 1], cell[:, 2])
    bucket = torch.clamp(hi >> (30 - _HIST_BITS), 0, (1 << _HIST_BITS) - 1)
    return torch.where(mask, bucket, (1 << _HIST_BITS) - 1), (hi, lo)


def _splitters(pos, mask, n: int, mesh: Mesh):
    lmin, lmax = batch_bounds(pos, mask)
    # one all-reduce for both: max(x) = -min(-x) exactly
    g = _comm.all_reduce(torch.cat([lmin, -lmax]), "min", mesh)
    gmin, gmax = g[:3], -g[3:]
    # isotropic cells: a per-axis scale would stretch a thin axis (a
    # survey's z) across the whole range and break the curve's locality
    extent = torch.clamp_min(torch.max(gmax - gmin), 1e-9).expand(3)
    bucket, keys = _morton_hi_bucket(pos, mask, gmin, extent)
    hist = torch.zeros(1 << _HIST_BITS, dtype=torch.int64,
                       device=pos.device).index_add_(
        0, bucket, mask.to(torch.int64))
    ghist = _comm.all_reduce(hist, "sum", mesh)
    csum = torch.cumsum(ghist, 0)
    total = torch.clamp_min(csum[-1], 1)
    dest_of_bucket = torch.clamp(((csum - ghist // 2) * n) // total,
                                 0, n - 1)
    return MortonPartitionSpec(gmin, extent.contiguous(),
                               dest_of_bucket), bucket, keys


def morton_partition(batch: PointBatch, mesh: Mesh,
                     axis: str = POINTS_AXIS,
                     capacity_factor: float = 2.0,
                     spec: Optional[MortonPartitionSpec] = None,
                     return_spec: bool = False,
                     sort_local: bool = False):
    """Repartition so each rank owns a contiguous Morton range.

    ``batch`` is this rank's shard over ``axis`` (:func:`~.mesh.shard_batch`:
    its valid rows the prefix of ``count``).  Returns ``(partitioned batch,
    per_shard_counts, per_shard_dropped)``: the batch holds this rank's
    Morton block as its prefix of ``per_shard_counts[r]`` rows (``r`` its
    coordinate on ``axis``) in ``per · capacity_factor`` rows (zero past
    it), and its ``count`` is the global total, as in the reference;
    ``per_shard_counts`` and ``per_shard_dropped`` are int64 of the axis's
    length ``n``, the same on every rank.  ``per_shard_dropped[d]`` counts
    the rows shard ``d`` could not send because a destination's ``slot =
    ceil(per · capacity_factor / n)`` budget overflowed — callers check
    that it sums to 0.  The budget is per (source, destination) pair:
    spatially sorted input needs ``capacity_factor`` up to the size,
    randomly ordered input 2.0.

    ``spec``: the splitters of an earlier run (co-partitioning) instead of
    equal-mass splitters of this batch; ``return_spec``: also return this
    run's :class:`MortonPartitionSpec`; ``sort_local``: sort the received
    block by Morton key, so its first and last valid rows are its
    key-extremal rows (what :func:`~.halo.halo_exchange` needs).

    Example — 512 points over a one-rank world's mesh, nothing dropped,
    every point accounted for:

    >>> import numpy as np, torch.distributed as dist
    >>> from pasture_tpu_torch.buffers.device import PointBatch
    >>> from pasture_tpu_torch.buffers.host import HostPointBuffer
    >>> from pasture_tpu_torch.layout import attributes as att
    >>> from pasture_tpu_torch.layout.schema import PointSchema
    >>> from pasture_tpu_torch.parallel import (
    ...     initialize_multihost, make_mesh, morton_partition, shard_batch)
    >>> from pasture_tpu_torch.parallel.spawn import free_port
    >>> initialize_multihost(f"localhost:{free_port()}", 1, 0, device="cpu")
    >>> rng = np.random.default_rng(0)
    >>> schema = PointSchema.from_attributes([att.POSITION_3D])
    >>> host = HostPointBuffer.from_columns(schema, {
    ...     att.POSITION_3D.name: rng.uniform(0, 8, (512, 3))})
    >>> mesh = make_mesh(1, device="cpu")
    >>> batch = shard_batch(PointBatch.from_host(host, capacity=512,
    ...                                          device="cpu"), mesh)
    >>> part, counts, dropped = morton_partition(batch, mesh,
    ...                                          capacity_factor=4.0)
    >>> int(counts.sum()), int(dropped.sum())
    (512, 0)
    >>> dist.destroy_process_group()
    """
    line = mesh.along(axis)
    n = line.size
    pos = batch.data[att.POSITION_3D.name]
    dev = pos.device
    per = pos.shape[0]
    cap_out = int(per * capacity_factor)
    slot = (cap_out + n - 1) // n
    local_count = torch.clamp(batch.count.to(torch.int64), 0, per)
    mask = torch.arange(per, device=dev) < local_count

    if spec is None:
        spec, bucket, _ = _splitters(pos, mask, n, line)
    else:
        spec = MortonPartitionSpec(*(t.to(dev) for t in spec))
        bucket, _ = _morton_hi_bucket(pos, mask, spec.gmin, spec.extent)
    dest = torch.where(mask, spec.dest_of_bucket[bucket], n)

    # stable order by destination: each destination's rows are one run,
    # in input order; the first `slot` of each run are sent
    order = torch.sort(dest, stable=True).indices
    runs = torch.bincount(dest, minlength=n + 1)[:n]
    starts = torch.cumsum(runs, 0) - runs
    sent = torch.clamp_max(runs, slot)
    j = torch.arange(slot, device=dev)
    ok = j[None, :] < sent[:, None]                          # (n, slot)
    rows = order[torch.where(ok, starts[:, None] + j[None, :], 0)]
    dropped = local_count - sent.sum()

    names = list(batch.data)
    blocks = []
    for name in names:
        v = batch.data[name][rows]                           # (n, slot, ...)
        okv = ok.reshape(ok.shape + (1,) * (v.ndim - 2))
        blocks.append(torch.where(okv, v, torch.zeros_like(v)))
    buf, layout = _comm.pack(blocks + [sent[:, None]], n)
    recv = _comm.unpack(_comm.all_to_all(buf, line), layout)
    recv_counts = recv[-1][:, 0]

    # compact each source's valid prefix, in source order
    new_count = recv_counts.sum()
    incl = torch.cumsum(recv_counts, 0)
    i = torch.arange(cap_out, device=dev)
    src = torch.clamp_max(torch.searchsorted(incl, i, right=True), n - 1)
    take = src * slot + (i - (incl[src] - recv_counts[src]))
    live = i < new_count
    take = torch.where(live, take, 0)
    new_cols = {}
    for name, block in zip(names, recv[:-1]):
        flat = block.reshape((n * slot,) + tuple(block.shape[2:]))
        v = flat[take]
        lv = live.reshape((cap_out,) + (1,) * (v.ndim - 1))
        new_cols[name] = torch.where(lv, v, torch.zeros_like(v))

    if sort_local:
        posn = new_cols[att.POSITION_3D.name]
        _, (hi, lo) = _morton_hi_bucket(posn, live, spec.gmin, spec.extent)
        key = torch.where(live, (hi << 30) | lo,
                          torch.full_like(hi, (_INVALID << 30) | _INVALID))
        perm = torch.sort(key, stable=True).indices
        new_cols = {k: v[perm] for k, v in new_cols.items()}

    gathered = _comm.all_gather(torch.stack([new_count, dropped]), line)
    counts, drops = gathered[:, 0], gathered[:, 1]
    out = PointBatch(new_cols, counts.sum().to(torch.int32), batch.schema,
                     batch.meta, batch.policy)
    if return_spec:
        return out, counts, drops, spec
    return out, counts, drops
