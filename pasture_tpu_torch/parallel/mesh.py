"""Meshes over ``torch.distributed`` ranks, and batch sharding.

Port of pasture_tpu/parallel/mesh.py.  The JAX package builds a
``jax.sharding.Mesh`` over devices and runs one program over it; the port
runs one process per device, and a :class:`Mesh` is this rank's view of a
group of ranks: its process group, its rank and the group's size, its
device and the group's backend, and ``shape = {"points": size}`` so that
``mesh.shape[axis]`` reads as in the reference.

The backend follows the device: the card (``device=None``) means NCCL, the
CPU gloo.  Gloo on the card is taken only when asked for
(``backend="gloo"``): several ranks that share one card, whose collectives
stage through host memory in :mod:`._comm`.  NCCL that cannot start raises;
nothing falls back to gloo.

A sharded batch is this rank's slice (:func:`shard_batch`): the capacity
padded to a multiple of the size, rank ``r`` holding rows ``[r·per,
(r+1)·per)`` and the count clipped to them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..buffers.device import PointBatch

__all__ = ["Mesh", "make_mesh", "batch_sharding", "shard_batch",
           "mesh_backend", "POINTS_AXIS"]

POINTS_AXIS = "points"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1-D group of ranks, one device each."""

    group: Any                  # the torch.distributed process group
    rank: int                   # this rank's index in the group
    size: int
    device: torch.device
    backend: str                # "nccl" or "gloo"
    axis_names: Tuple[str, ...] = (POINTS_AXIS,)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    @property
    def staged(self) -> bool:
        """Collectives copy through host memory (gloo on the card)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def mesh_backend(device: torch.device, backend: Optional[str] = None
                 ) -> str:
    """The backend of a mesh on ``device``: NCCL on the card unless
    ``backend="gloo"`` is asked for; gloo on the CPU."""
    if device.type == "cuda":
        if backend not in (None, "nccl", "gloo"):
            raise ValueError(f"unknown backend {backend!r}")
        return backend or "nccl"
    if backend not in (None, "gloo"):
        raise ValueError(f"a mesh on {device} runs on gloo, not {backend!r}")
    return "gloo"


def _check_axes(axes, shape, n: int) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) != 1 or (shape is not None and tuple(shape) != (n,)):
        raise NotImplementedError(
            f"mesh axes {axes} with shape {shape}: the port builds 1-D "
            f"meshes only; a 2-D (hosts, points) mesh waits for a "
            f"multi-card run")
    return axes


def make_mesh(n_devices: Optional[int] = None,
              axes: Union[str, Sequence[str]] = POINTS_AXIS,
              shape: Optional[Tuple[int, ...]] = None,
              device: Optional[Union[str, torch.device]] = None,
              backend: Optional[str] = None) -> Optional[Mesh]:
    """A mesh over the first ``n_devices`` ranks of the default group (all
    of them by default), through ``dist.new_group`` — which every rank of
    the default group must call.  A rank outside the mesh gets ``None``.

    ``device=None`` means the card (the current CUDA device; raises
    without one) and NCCL; ``device="cpu"`` gloo; ``backend="gloo"`` with
    the card is the shared-card world (see the module doc)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: call "
                           "initialize_multihost(...) first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n} of a world of {world}")
    axes = _check_axes(axes, shape, n)
    dev = resolve_device(device)
    be = mesh_backend(dev, backend)
    group = dist.new_group(list(range(n)), backend=be)
    rank = dist.get_rank()
    if rank >= n:
        return None
    return Mesh(group, rank, n, dev, be, axes)


class RowSharding(NamedTuple):
    """Rows of a batch sharded over a mesh: ``per`` rows a rank, this
    rank's ``[start, stop)`` of the ``capacity`` padded rows."""

    per: int
    start: int
    stop: int
    capacity: int


def batch_sharding(mesh: Mesh, batch: PointBatch,
                   axis: str = POINTS_AXIS) -> RowSharding:
    """The row layout of ``batch`` sharded over ``axis``: point columns
    split into equal blocks along their first axis (the capacity padded to
    a multiple of the size first), count and meta replicated."""
    n = mesh.shape[axis]
    cap = (batch.capacity + n - 1) // n * n
    per = cap // n
    return RowSharding(per, mesh.rank * per, (mesh.rank + 1) * per, cap)


def shard_batch(batch: PointBatch, mesh: Mesh,
                axis: str = POINTS_AXIS) -> PointBatch:
    """This rank's shard of ``batch`` on the mesh device: rows
    ``[r·per, (r+1)·per)`` of the batch padded to a multiple of the size,
    its count clipped to them (``clip(count - r·per, 0, per)``); meta
    replicated."""
    rows = batch_sharding(mesh, batch, axis)
    if rows.capacity != batch.capacity:
        batch = batch.pad_to(rows.capacity)
    dev = mesh.device
    data = {k: v[rows.start:rows.stop].to(dev) for k, v in batch.data.items()}
    count = torch.clamp(batch.count.to(dev) - rows.start, 0, rows.per)
    return PointBatch(data, count.to(torch.int32), batch.schema,
                      {k: v.to(dev) for k, v in batch.meta.items()},
                      batch.policy)
