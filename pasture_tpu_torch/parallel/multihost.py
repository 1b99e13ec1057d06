"""Process-group start-up and meshes over the whole world.

Port of pasture_tpu/parallel/multihost.py.  Nothing tells a process of a
cluster here (the JAX package reads Cloud TPU metadata): the caller names
the coordinator, the world size and its own rank, and
:func:`initialize_multihost` starts ``torch.distributed`` on them.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .._device import resolve_device
from .mesh import POINTS_AXIS, Mesh, make_mesh, mesh_backend

__all__ = ["initialize_multihost", "global_mesh"]


def initialize_multihost(coordinator_address: str, num_processes: int,
                         process_id: int,
                         device: Optional[Union[str, torch.device]] = None,
                         backend: Optional[str] = None,
                         timeout_s: float = 600.0) -> None:
    """``dist.init_process_group`` over TCP: ``coordinator_address`` is
    ``"host:port"`` (rank 0 listens there), ``num_processes`` the world
    size, ``process_id`` this rank.  The default group's backend follows
    ``device`` as a mesh's does (:func:`~.mesh.mesh_backend`: the card and
    NCCL unless ``backend="gloo"``; the CPU and gloo)."""
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize_multihost needs coordinator_address, "
                         "num_processes and process_id: nothing detects a "
                         "cluster")
    be = mesh_backend(resolve_device(device), backend)
    dist.init_process_group(
        backend=be, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=timedelta(seconds=timeout_s))


def global_mesh(axes: Sequence[str] = (POINTS_AXIS,),
                shape: Optional[Tuple[int, ...]] = None,
                device: Optional[Union[str, torch.device]] = None,
                backend: Optional[str] = None) -> Mesh:
    """A mesh over every rank of the world: 1-D by default; a multi-axis
    ``shape`` lays the ranks out row-major, e.g. ``axes=("hosts",
    "points"), shape=(num_hosts, ranks_per_host)`` keeps the collectives
    of an op sharded over ``"points"`` inside a host (each host's line of
    ranks) and makes the cross-host traffic explicit (ops over
    ``"hosts"``)."""
    return make_mesh(None, axes, shape, device=device, backend=backend)
