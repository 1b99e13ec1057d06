"""Sharded, host-parallel file ingest.

Port of pasture_tpu/parallel/ingest.py: files are read concurrently on
host threads (mmap and vectorised decode release the interpreter lock),
converted to one schema and concatenated; each rank then uploads its own
rows to its device.  The JAX package has every process read every file
and keep its rows; here a rank reads the headers of every file for their
point counts, then reads only its own rows of the concatenation (a
straddled file from its first row on; a file whose reader cannot seek,
``.pnts``, whole), so the ranks decode the files once between them.  The
rows each rank holds are the same.

A rank's rows take one of two paths, chosen by what the files and the
schema are:

* **the record path**, where every file that holds one of the rank's rows
  is an uncompressed LAS file opened from a path (its reader reads raw
  record ranges, :meth:`~..io.las.LasReader.read_records_into`) and every
  member of the schema is the position (float32 or float64 under the
  policy), a field of the wire's own dtype (its carrier at most wider: u16
  in int32) or a member the file lacks (zero-filled).  The raw records go
  file -> pinned staging -> card in chunks of :data:`CHUNK_BYTES`, through
  two sets of a pinned host chunk and a device chunk made once a device
  and reused by every later call (:class:`_Staging`): a set's host chunk
  is refilled, by ``os.preadv`` on a few threads, once the copy that last
  read it has completed; its device chunk is copied to on a stream of its
  own once the decode that last read it has completed; K9
  (``ops.kernels.las_records_decode``) decodes each chunk on the current
  stream straight into the shard's columns, made once at capacity.  On the
  CPU the same pipeline runs with K9's plain version, each host chunk
  decoded where it lies.
* **the host path** otherwise (LAZ, ``.pnts``, a schema that needs the
  flags fanned out or a dtype converted, a policy that narrows positions
  to neither float32 nor float64): each file's rows decoded on host
  threads by its reader, concatenated, then ``PointBatch.from_host``.

:data:`POINTS_DECODED` counts the rows a rank decodes (``"sharded_read_all"``)
and, of those, the rows that went the record path (``"on_card"``).
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..buffers.device import PointBatch, column_carrier
from ..buffers.host import HostPointBuffer
from ..io import open_reader
from ..io.base import SeekToPoint
from ..io.las import LasReader
from ..layout.dtypes import DevicePolicy
from ..layout.schema import PointSchema
from ..ops.kernels.las_decode_kernel import (las_records_decode,
                                             supports_record_size)
from .mesh import POINTS_AXIS, Mesh
from .spans import span

__all__ = ["sharded_read_all", "read_files_parallel", "POINTS_DECODED"]

#: rows of :func:`sharded_read_all`, cumulative: what it decoded of its
#: files on this rank, and of those the rows that went the record path
POINTS_DECODED = {"sharded_read_all": 0, "on_card": 0}
#: bytes of one staging chunk, host and device alike
CHUNK_BYTES = 32 << 20
#: a read thread's least share of a chunk
_READ_BYTES = 4 << 20
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


def _read_rows(reader, lo: int, hi: int, schema: PointSchema
               ) -> Tuple[HostPointBuffer, int]:
    """Rows ``[lo, hi)`` of one file and the points decoded for them: from
    ``lo`` on where the reader can seek, else the whole file, sliced."""
    if isinstance(reader, SeekToPoint):
        reader.seek_point(lo)
        buf = reader.read(hi - lo, schema=schema)
        return buf, len(buf)
    buf = reader.read_all(schema=schema)
    return buf.slice(lo, hi), len(buf)


def _read_host(readers, pieces, schema, max_workers) -> HostPointBuffer:
    """The host path's rows: each piece decoded on a host thread."""
    bufs = []
    if pieces:
        with ThreadPoolExecutor(
                max_workers=min(max_workers, len(pieces))) as ex:
            futs = [ex.submit(_read_rows, r, lo, hi, schema)
                    for r, (lo, hi) in zip(readers, pieces)]
            for f in futs:
                buf, decoded = f.result()
                bufs.append(buf)
                POINTS_DECODED["sharded_read_all"] += decoded
    if not bufs:
        return HostPointBuffer.empty(schema, 0)
    return bufs[0] if len(bufs) == 1 else HostPointBuffer.concat(bufs)


def _takes_member(member, policy: DevicePolicy, position: bool) -> bool:
    """Whether K9 writes ``member``'s column as the host path would
    (``column_carrier``): a position carried as float32 or float64, or a
    field whose carrier holds the wire's components unchanged."""
    carrier, unchanged = column_carrier(member.dtype, policy)
    if position:
        return carrier in (np.float32, np.float64)
    return unchanged


def _record_plans(readers, schema: PointSchema,
                  policy: DevicePolicy) -> Optional[List[dict]]:
    """Each reader's record plan (``LasReader.record_plan``) where the
    record path applies to every one of them, else ``None``."""
    plans = []
    for r in readers:
        if not isinstance(r, LasReader) or not r.reads_records() \
                or not supports_record_size(r.record_size):
            return None
        plan = r.record_plan(schema)
        if plan is None:
            return None
        members = [(m, False) for _, m in plan["fields"]]
        if plan["position"] is not None:
            members.append((plan["position"][1], True))
        if not all(_takes_member(m, policy, p) for m, p in members):
            return None
        plans.append(plan)
    return plans


class _Staging:
    """Two sets of a host chunk (pinned for a card) and a device chunk of
    ``nbytes`` (rounded up to whole 16-byte words) each for one device,
    made once and reused by every call (:func:`_staging`); on the CPU a
    set's device chunk is its host chunk.  Copies go on a stream of their
    own."""

    def __init__(self, device: torch.device, nbytes: int = CHUNK_BYTES
                 ) -> None:
        cuda = device.type == "cuda"
        nbytes = -(-nbytes // 16) * 16
        self.device, self.nbytes = device, nbytes
        self.host = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
                     for _ in range(2)]
        self.card = ([torch.empty(nbytes, dtype=torch.uint8, device=device)
                      for _ in range(2)] if cuda else self.host)
        self.stream = torch.cuda.Stream(device) if cuda else None
        #: per set, the copy that last read its host chunk and the decode
        #: that last read its device chunk
        self.copied: List[Optional[torch.cuda.Event]] = [None, None]
        self.decoded: List[Optional[torch.cuda.Event]] = [None, None]
        self.lock = threading.Lock()

    def fill(self, i: int, reader: LasReader, lo: int, n: int,
             pool: ThreadPoolExecutor, threads: int) -> None:
        """Records ``[lo, lo + n)`` of ``reader`` into host chunk ``i``, on
        the pool's threads, once the copy that last read it has
        completed."""
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        rs = reader.record_size
        buf = self.host[i].numpy()
        step = max(-(-n // threads), -(-_READ_BYTES // rs))
        futs = [pool.submit(reader.read_records_into, buf[(a - lo) * rs:],
                            a, min(step, lo + n - a))
                for a in range(lo, lo + n, step)]
        for f in futs:
            f.result()

    def to_device(self, i: int, nbytes: int) -> torch.Tensor:
        """Device chunk ``i`` holding host chunk ``i``'s first ``nbytes``,
        ready for the current stream."""
        if self.stream is None:
            return self.card[i]
        with torch.cuda.stream(self.stream):
            if self.decoded[i] is not None:
                self.stream.wait_event(self.decoded[i])
            self.card[i][:nbytes].copy_(self.host[i][:nbytes],
                                        non_blocking=True)
            self.copied[i] = torch.cuda.Event()
            self.copied[i].record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(self.copied[i])
        return self.card[i]

    def decoding_done(self, i: int) -> None:
        """Mark device chunk ``i`` as read by what the current stream has
        been given so far."""
        if self.stream is not None:
            self.decoded[i] = torch.cuda.Event()
            self.decoded[i].record(torch.cuda.current_stream(self.device))


_STAGING: Dict[torch.device, _Staging] = {}
_STAGING_LOCK = threading.Lock()


def _staging(device: torch.device) -> _Staging:
    """The device's staging, made at its first call."""
    with _STAGING_LOCK:
        st = _STAGING.get(device)
        if st is None:
            st = _STAGING[device] = _Staging(device)
        return st


def _read_records(readers, pieces, plans, schema: PointSchema,
                  policy: DevicePolicy, capacity: int, device: torch.device,
                  max_workers: int) -> PointBatch:
    """The record path: the rows of every piece, file -> staging -> device,
    decoded by K9 into columns of ``capacity`` rows (zero past the
    count)."""
    data = {m.name: torch.zeros(
                (capacity,) + m.dtype.np_shape, device=device,
                dtype=getattr(torch, column_carrier(m.dtype, policy)[0].name))
            for m in schema.members}
    row = 0
    if pieces:
        st = _staging(device)
        with st.lock, ThreadPoolExecutor(max_workers=max_workers) as pool:
            turn = 0
            for r, (lo, hi), plan in zip(readers, pieces, plans):
                rs = r.record_size
                pos_offset, positions = 0, None
                if plan["position"] is not None:
                    pos_offset = plan["position"][0]
                    positions = data[plan["position"][1].name]
                fields = [(off, m.dtype.np_component_dtype.itemsize,
                           data[m.name]) for off, m in plan["fields"]]
                scale = r.header.scale_np.tolist()
                offset = r.header.offset_np.tolist()
                per = st.nbytes // rs
                for a in range(lo, hi, per):
                    n = min(per, hi - a)
                    st.fill(turn, r, a, n, pool, max_workers)
                    rec = st.to_device(turn, n * rs)
                    las_records_decode(rec, n, rs, row, scale, offset,
                                       pos_offset, positions, fields)
                    st.decoding_done(turn)
                    turn ^= 1
                    row += n
                POINTS_DECODED["sharded_read_all"] += hi - lo
                POINTS_DECODED["on_card"] += hi - lo
    count = torch.tensor(row, dtype=torch.int32, device=device)
    return PointBatch(data, count, schema, {}, policy)


def sharded_read_all(paths: Sequence[Union[str, Path]], mesh: Mesh,
                     schema: Optional[PointSchema] = None,
                     axis: str = POINTS_AXIS,
                     policy: DevicePolicy = DevicePolicy.NARROW,
                     max_workers: int = 8,
                     capacity_multiple: int = 1) -> PointBatch:
    """Files -> this rank's shard over ``axis`` on the mesh device:
    exactly :func:`~.mesh.shard_batch`'s rows of the concatenated files
    (``per = ceil(points / ranks)`` rows a rank, capacity ``per``),
    uploaded alone.  The rank reads every file's header, then reads only
    the files that hold its rows, and of those only its rows, by the
    record path or the host path (module doc; :data:`POINTS_DECODED`
    counts both).  Without ``schema`` the first file's default schema is
    used; every file converts into it.  ``max_workers`` threads read.

    ``capacity_multiple`` pads the shard's capacity up to a multiple of it,
    the padding invalid (past the count), so that tiles of that many rows
    divide a shard (``voxel_downsample(..., sort_tiles=capacity //
    rows)``); the rows held are the same.

    Spans (:mod:`.spans`): ``read`` covers the headers and the row plan,
    and on the host path the decode; ``upload`` the rest: on the record
    path the whole pipeline from the first file read to the last decode,
    on the host path ``PointBatch.from_host``."""
    paths = list(paths)
    if not paths:
        raise ValueError("no input files")
    if capacity_multiple < 1:
        raise ValueError(f"capacity_multiple={capacity_multiple} < 1")
    with contextlib.ExitStack() as stack:
        with span("read", _HOST):
            counts, schema = _point_counts(paths, schema)
            line = mesh.along(axis)
            total = sum(counts)
            per = max((total + line.size - 1) // line.size, 1)
            start = min(line.rank * per, total)
            stop = min(start + per, total)
            readers, pieces, at = [], [], 0
            for path, n in zip(paths, counts):
                lo, hi = max(start - at, 0), min(stop - at, n)
                if lo < hi:
                    readers.append(stack.enter_context(open_reader(path)))
                    pieces.append((lo, hi))
                at += n
            plans = _record_plans(readers, schema, policy)
            if plans is None:
                rows = _read_host(readers, pieces, schema, max_workers)
        m = int(capacity_multiple)
        capacity = (per + m - 1) // m * m
        with span("upload", mesh.device):
            if plans is not None:
                return _read_records(readers, pieces, plans, schema, policy,
                                     capacity, mesh.device, max_workers)
            return PointBatch.from_host(rows, policy=policy,
                                        capacity=capacity,
                                        device=mesh.device)
