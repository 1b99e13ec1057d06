"""Sharded, host-parallel file ingest.

Port of pasture_tpu/parallel/ingest.py: files are read concurrently on
host threads (mmap and vectorised decode release the interpreter lock),
converted to one schema and concatenated; each rank then uploads its own
rows to its device.  Every rank reads every file — simple, and each rank's
shard is then exactly its rows of the concatenation.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence, Union

from ..buffers.device import PointBatch
from ..buffers.host import HostPointBuffer
from ..io import open_reader
from ..layout.dtypes import DevicePolicy
from ..layout.schema import PointSchema
from .mesh import POINTS_AXIS, Mesh

__all__ = ["sharded_read_all", "read_files_parallel"]


def read_files_parallel(paths: Sequence[Union[str, Path]],
                        schema: Optional[PointSchema] = None,
                        max_workers: int = 8) -> HostPointBuffer:
    """Read many point-cloud files concurrently into one host buffer.

    Without ``schema`` the first file's default schema is used; every other
    file converts into it (zero-filled where attributes are missing)."""
    paths = list(paths)
    if not paths:
        raise ValueError("no input files")
    if schema is None:
        with open_reader(paths[0]) as r:
            schema = r.get_default_point_schema()

    def read_one(path):
        with open_reader(path) as r:
            return r.read_all(schema=schema)

    with ThreadPoolExecutor(max_workers=min(max_workers, len(paths))) as ex:
        buffers = list(ex.map(read_one, paths))
    return HostPointBuffer.concat(buffers)


def sharded_read_all(paths: Sequence[Union[str, Path]], mesh: Mesh,
                     schema: Optional[PointSchema] = None,
                     axis: str = POINTS_AXIS,
                     policy: DevicePolicy = DevicePolicy.NARROW,
                     max_workers: int = 8) -> PointBatch:
    """Files -> host-parallel read -> this rank's shard over ``axis`` on
    the mesh device: exactly :func:`~.mesh.shard_batch`'s rows of the
    concatenated batch (capacity padded to a multiple of the axis's size),
    uploaded alone."""
    host = read_files_parallel(paths, schema, max_workers)
    line = mesh.along(axis)
    n = line.size
    per = max((len(host) + n - 1) // n, 1)
    start = min(line.rank * per, len(host))
    rows = host.slice(start, min(start + per, len(host)))
    return PointBatch.from_host(rows, policy=policy, capacity=per,
                                device=mesh.device)
