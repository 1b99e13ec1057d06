"""Sharded, host-parallel file ingest.

Port of pasture_tpu/parallel/ingest.py: files are read concurrently on
host threads (mmap and vectorised decode release the interpreter lock),
converted to one schema and concatenated; each rank then uploads its own
rows to its device.  The JAX package has every process read every file
and keep its rows; here a rank reads the headers of every file for their
point counts, then decodes only its own rows of the concatenation (a
straddled file from its first row on, through the reader's
``seek_point``; a file whose reader cannot seek, ``.pnts``, whole), so the
ranks decode the files once between them.  The rows each rank holds are
the same.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..buffers.device import PointBatch
from ..buffers.host import HostPointBuffer
from ..io import open_reader
from ..io.base import SeekToPoint
from ..layout.dtypes import DevicePolicy
from ..layout.schema import PointSchema
from .mesh import POINTS_AXIS, Mesh
from .spans import span

__all__ = ["sharded_read_all", "read_files_parallel", "POINTS_DECODED"]

#: points decoded on this rank's host, cumulative: what each call of
#: :func:`sharded_read_all` read of its files
POINTS_DECODED = {"sharded_read_all": 0}
_HOST = torch.device("cpu")


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


def _point_counts(paths, schema):
    """Each file's point count from its header, and the schema (the first
    file's default where none is given)."""
    counts: List[int] = []
    for path in paths:
        with open_reader(path) as r:
            if schema is None:
                schema = r.get_default_point_schema()
            counts.append(int(r.get_metadata().number_of_points()))
    return counts, schema


def _read_rows(path, lo: int, hi: int, schema: PointSchema
               ) -> Tuple[HostPointBuffer, int]:
    """Rows ``[lo, hi)`` of one file and the points decoded for them: from
    ``lo`` on where the reader can seek, else the whole file, sliced."""
    with open_reader(path) as r:
        if isinstance(r, SeekToPoint):
            r.seek_point(lo)
            buf = r.read(hi - lo, schema=schema)
            return buf, len(buf)
        buf = r.read_all(schema=schema)
        return buf.slice(lo, hi), len(buf)


def sharded_read_all(paths: Sequence[Union[str, Path]], mesh: Mesh,
                     schema: Optional[PointSchema] = None,
                     axis: str = POINTS_AXIS,
                     policy: DevicePolicy = DevicePolicy.NARROW,
                     max_workers: int = 8,
                     capacity_multiple: int = 1) -> PointBatch:
    """Files -> this rank's shard over ``axis`` on the mesh device:
    exactly :func:`~.mesh.shard_batch`'s rows of the concatenated files
    (``per = ceil(points / ranks)`` rows a rank, capacity ``per``),
    uploaded alone.  The rank reads every file's header, then decodes
    only the files that hold its rows, on host threads, and of those only
    its rows (:data:`POINTS_DECODED` counts what it decodes).  Without
    ``schema`` the first file's default schema is used; every file
    converts into it.

    ``capacity_multiple`` pads the shard's capacity up to a multiple of it,
    the padding invalid (past the count), so that tiles of that many rows
    divide a shard (``voxel_downsample(..., sort_tiles=capacity //
    rows)``); the rows held are the same."""
    paths = list(paths)
    if not paths:
        raise ValueError("no input files")
    if capacity_multiple < 1:
        raise ValueError(f"capacity_multiple={capacity_multiple} < 1")
    with span("read", _HOST):
        counts, schema = _point_counts(paths, schema)
        line = mesh.along(axis)
        total = sum(counts)
        per = max((total + line.size - 1) // line.size, 1)
        start = min(line.rank * per, total)
        stop = min(start + per, total)
        pieces, at = [], 0
        for i, n in enumerate(counts):
            lo, hi = max(start - at, 0), min(stop - at, n)
            if lo < hi:
                pieces.append((i, lo, hi))
            at += n
        bufs = []
        if pieces:
            with ThreadPoolExecutor(
                    max_workers=min(max_workers, len(pieces))) as ex:
                futs = [ex.submit(_read_rows, paths[i], lo, hi, schema)
                        for i, lo, hi in pieces]
                for f in futs:
                    buf, decoded = f.result()
                    bufs.append(buf)
                    POINTS_DECODED["sharded_read_all"] += decoded
        if not bufs:
            rows = HostPointBuffer.empty(schema, 0)
        elif len(bufs) == 1:
            rows = bufs[0]
        else:
            rows = HostPointBuffer.concat(bufs)
    m = int(capacity_multiple)
    with span("upload", mesh.device):
        return PointBatch.from_host(rows, policy=policy,
                                    capacity=(per + m - 1) // m * m,
                                    device=mesh.device)
