"""Meshes over ``torch.distributed`` ranks, and batch sharding.

Port of pasture_tpu/parallel/mesh.py.  The JAX package builds a
``jax.sharding.Mesh`` over devices and runs one program over it; the port
runs one process per device, and a :class:`Mesh` is this rank's view of a
mesh of ranks of any rank (in the array sense): the ranks laid out
row-major over ``axis_names`` (as ``np.asarray(devices).reshape(shape)``
lays out the reference's devices), the mesh's process group, this rank's
index and coordinates, its device and the mesh's backend, and ``shape``
as a dict of every axis (``mesh.shape["hosts"]``), as in the reference.

An op sharded over one axis runs on that axis's *line* through this rank
(:meth:`Mesh.along`): the ranks that share every other coordinate, a 1-D
mesh of their own with its own process group.  The op's collectives meet
on the line, so the result is sharded over the axis and replicated over
the others, as a ``shard_map`` with ``P(axis)`` specs is.  The line of a
1-D mesh is the mesh itself.

The backend follows the device: the card (``device=None``) means NCCL, the
CPU gloo.  Gloo on the card is taken only when asked for
(``backend="gloo"``): several ranks that share one card, whose collectives
stage through host memory in :mod:`._comm`.  NCCL that cannot start raises;
nothing falls back to gloo.

A sharded batch is this rank's slice (:func:`shard_batch`): the capacity
padded to a multiple of the axis's size, the rank at coordinate ``r`` on
the axis holding rows ``[r·per, (r+1)·per)`` and the count clipped to them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..buffers.device import PointBatch

__all__ = ["Mesh", "make_mesh", "batch_sharding", "shard_batch",
           "mesh_backend", "POINTS_AXIS"]

POINTS_AXIS = "points"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh of ranks, one device each, laid out
    row-major over ``axis_names`` with the sizes ``dims``."""

    group: Any                  # the torch.distributed group of the mesh
    rank: int                   # this rank's index in the mesh (row-major)
    size: int                   # ranks in the mesh
    device: torch.device
    backend: str                # "nccl" or "gloo"
    axis_names: Tuple[str, ...] = (POINTS_AXIS,)
    dims: Tuple[int, ...] = ()  # the axes' sizes; () reads as (size,)
    # per axis, this rank's line along it (a 1-D Mesh); () on a 1-D mesh
    lines: Tuple["Mesh", ...] = dataclasses.field(default=(), repr=False,
                                                  compare=False)

    @property
    def shape(self) -> dict:
        """``{axis: size}`` of every axis, in order."""
        return dict(zip(self.axis_names, self.dims or (self.size,)))

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's coordinate on each axis, in order."""
        return tuple(int(c) for c in np.unravel_index(
            self.rank, self.dims or (self.size,)))

    @property
    def staged(self) -> bool:
        """Collectives copy through host memory (gloo on the card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def along(self, axis: str) -> "Mesh":
        """The 1-D mesh of the ranks that share this rank's coordinates on
        every axis but ``axis``: its process group, this rank's index on
        it (its coordinate on ``axis``), its size, this mesh's device and
        backend.  A 1-D mesh's line is the mesh itself."""
        if axis not in self.axis_names:
            raise KeyError(f"axis {axis!r} is not one of the mesh's "
                           f"{self.axis_names}")
        if len(self.axis_names) == 1:
            return self
        return self.lines[self.axis_names.index(axis)]


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


def _mesh_shape(axes, shape, n: int
                ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if not axes or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes}: one name an axis, at least "
                         f"one axis")
    if shape is None:
        if len(axes) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes) or min(shape) < 1 \
            or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} for axes {axes} does not lay "
                         f"out {n} ranks")
    return axes, shape


def _line_groups(shape: Tuple[int, ...], backend: str, rank: int) -> list:
    """For each axis, one process group a line of ranks along it, made by
    every rank of the default group in one fixed order (axes in order,
    lines row-major over the other coordinates: ``dist.new_group`` must be
    called by every rank for every group, in the same order, or the world
    hangs).  Returns, per axis, the group of the line through ``rank``
    (``None`` for a rank outside the mesh)."""
    grid = np.arange(math.prod(shape)).reshape(shape)
    mine = []
    for a in range(len(shape)):
        own = None
        for line in np.moveaxis(grid, a, -1).reshape(-1, shape[a]):
            group = dist.new_group(line.tolist(), backend=backend)
            if rank in line:
                own = group
        mine.append(own)
    return mine


def make_mesh(n_devices: Optional[int] = None,
              axes: Union[str, Sequence[str]] = POINTS_AXIS,
              shape: Optional[Tuple[int, ...]] = None,
              device: Optional[Union[str, torch.device]] = None,
              backend: Optional[str] = None) -> Optional[Mesh]:
    """A mesh over the first ``n_devices`` ranks of the default group (all
    of them by default), laid out row-major in ``shape`` over ``axes``:
    ``shape`` defaults to ``(n_devices,)`` for one axis and is required
    for several (``ValueError``), as in the reference.  Its groups come
    from ``dist.new_group`` — the mesh's, and one a line of each axis of
    a multi-axis mesh — which every rank of the default group must call.
    A rank outside the mesh gets ``None``.

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
    axes, shape = _mesh_shape(axes, shape, n)
    dev = resolve_device(device)
    be = mesh_backend(dev, backend)
    group = dist.new_group(list(range(n)), backend=be)
    rank = dist.get_rank()
    lines = _line_groups(shape, be, rank) if len(axes) > 1 else []
    if rank >= n:
        return None
    coords = np.unravel_index(rank, shape)
    views = tuple(Mesh(g, int(c), s, dev, be, (a,), (s,))
                  for g, c, s, a in zip(lines, coords, shape, axes))
    return Mesh(group, rank, n, dev, be, axes, shape, views)


class RowSharding(NamedTuple):
    """Rows of a batch sharded over a mesh axis: ``per`` rows a rank,
    this rank's ``[start, stop)`` of the ``capacity`` padded rows."""

    per: int
    start: int
    stop: int
    capacity: int


def batch_sharding(mesh: Mesh, batch: PointBatch,
                   axis: str = POINTS_AXIS) -> RowSharding:
    """The row layout of ``batch`` sharded over ``axis``: point columns
    split into equal blocks along their first axis (the capacity padded to
    a multiple of the axis's size first), block ``r`` on the ranks at
    coordinate ``r`` of the axis; count and meta replicated."""
    line = mesh.along(axis)
    n = line.size
    cap = (batch.capacity + n - 1) // n * n
    per = cap // n
    return RowSharding(per, line.rank * per, (line.rank + 1) * per, cap)


def shard_batch(batch: PointBatch, mesh: Mesh,
                axis: str = POINTS_AXIS) -> PointBatch:
    """This rank's shard of ``batch`` on the mesh device: rows
    ``[r·per, (r+1)·per)`` of the batch padded to a multiple of the axis's
    size, ``r`` this rank's coordinate on ``axis``, its count clipped to
    them (``clip(count - r·per, 0, per)``); meta replicated."""
    rows = batch_sharding(mesh, batch, axis)
    if rows.capacity != batch.capacity:
        batch = batch.pad_to(rows.capacity)
    dev = mesh.device
    data = {k: v[rows.start:rows.stop].to(dev) for k, v in batch.data.items()}
    count = torch.clamp(batch.count.to(dev) - rows.start, 0, rows.per)
    return PointBatch(data, count.to(torch.int32), batch.schema,
                      {k: v.to(dev) for k, v in batch.meta.items()},
                      batch.policy)
