"""Out-of-core streaming: bounded-memory file-to-device pipelines.

The reference processes files in bounded chunks (1-MiB reads, 50k-point
writes, 1M-point analysis chunks); this module is the device-era
equivalent: a generator of fixed-capacity :class:`PointBatch` chunks with
host read-ahead overlapping device compute, plus streaming reductions that
fold over chunks (bounds, voxel downsampling via the two-stage merge).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..buffers.device import PointBatch
from ..buffers.host import HostPointBuffer
from ..layout import attributes as att
from ..layout.dtypes import DevicePolicy, carrier_np_dtype
from ..layout.schema import PointSchema
from ..math.aabb import AABB
from .base import open_reader

__all__ = ["stream_batches", "streaming_bounds", "streaming_voxel_downsample",
           "HOST_SYNCS"]

#: host reads of device values by the fold (each ``.tolist()`` waits for
#: the device): the capacity schedule's count fetches and its checks
HOST_SYNCS = {"streaming_voxel_downsample": 0}


class _PinnedUpload:
    """Uploads host chunks to one CUDA device from two sets of pinned
    buffers, alternating, on a stream of its own.  A set is refilled only
    after the copy that last read it has completed (its event)."""

    def __init__(self, device: torch.device, capacity: int,
                 policy: DevicePolicy) -> None:
        self.device, self.capacity, self.policy = device, capacity, policy
        self.stream = torch.cuda.Stream(device)
        self.sets: List[Dict[str, torch.Tensor]] = [{}, {}]
        self.events: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0

    def __call__(self, buf: HostPointBuffer):
        """``(batch, event)``: the batch's tensors are ready on the device
        once ``event`` has completed."""
        i, self.turn = self.turn, self.turn ^ 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        pinned, n = self.sets[i], len(buf)
        data = {}
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for m in buf.schema.members:
                logical = self.policy.np_dtype(m.dtype)
                with np.errstate(over="ignore", invalid="ignore"):
                    host = buf.columns[m.name].astype(logical).astype(
                        carrier_np_dtype(logical), copy=False)
                p = pinned.get(m.name)
                if p is None:
                    p = torch.empty((self.capacity,) + host.shape[1:],
                                    dtype=torch.from_numpy(host[:0]).dtype,
                                    pin_memory=True)
                    pinned[m.name] = p
                p[:n].numpy()[...] = host
                if n < self.capacity:
                    p[n:].zero_()
                data[m.name] = p.to(self.device, non_blocking=True)
            count = torch.full((), n, dtype=torch.int32, device=self.device)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[i] = event
        return PointBatch(data, count, buf.schema, {}, self.policy), event


def stream_batches(path: Union[str, Path], chunk_points: int = 1 << 20,
                   schema: Optional[PointSchema] = None,
                   policy: DevicePolicy = DevicePolicy.NARROW,
                   read_ahead: bool = True,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Iterator[PointBatch]:
    """Yield fixed-capacity device batches of ``chunk_points`` each
    (``device=None`` means the GPU and raises without one).

    With ``read_ahead`` the next chunk is parsed AND uploaded on a host
    thread while the caller computes on the current one.  On the GPU the
    upload goes from pinned host buffers on a CUDA stream of its own; the
    caller's stream waits for it before the batch is handed over.  Every
    batch has capacity ``chunk_points``; the last one is padded with zeros
    (check ``batch.count``).
    """
    dev = resolve_device(device)
    reader = open_reader(path)

    def read_host():
        buf = reader.read(chunk_points, schema=schema)
        return buf if len(buf) else None

    try:
        if not read_ahead:
            while True:
                buf = read_host()
                if buf is None:
                    return
                yield PointBatch.from_host(buf, policy=policy,
                                           capacity=chunk_points, device=dev)
        if dev.type == "cuda":
            upload = _PinnedUpload(dev, chunk_points, policy)
        else:
            def upload(buf):
                return PointBatch.from_host(buf, policy=policy,
                                            capacity=chunk_points,
                                            device=dev), None

        def read_chunk():
            buf = read_host()
            return None if buf is None else upload(buf)

        with ThreadPoolExecutor(max_workers=1) as ex:
            future = ex.submit(read_chunk)
            while True:
                got = future.result()
                if got is None:
                    return
                future = ex.submit(read_chunk)
                batch, event = got
                if event is not None:
                    consumer = torch.cuda.current_stream(dev)
                    consumer.wait_event(event)
                    # the tensors were made on the upload stream: tell the
                    # allocator that the caller's stream uses them too
                    for t in (*batch.data.values(), batch.count):
                        t.record_stream(consumer)
                yield batch
    finally:
        close = getattr(reader, "close", None)
        if close:
            close()


def streaming_bounds(path: Union[str, Path], chunk_points: int = 1 << 20,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Optional[AABB]:
    """AABB of an arbitrarily large file in bounded memory (the reference's
    chunked min/max scan, info.rs:95-160, on the device)."""
    from ..ops.reductions import batch_bounds

    mn = mx = None
    for batch in stream_batches(path, chunk_points, device=device):
        bmin, bmax = batch_bounds(batch.data[att.POSITION_3D.name],
                                  batch.valid_mask())
        bmin = bmin.cpu().numpy().astype(np.float64)
        bmax = bmax.cpu().numpy().astype(np.float64)
        mn = bmin if mn is None else np.minimum(mn, bmin)
        mx = bmax if mx is None else np.maximum(mx, bmax)
    if mn is None:
        return None
    return AABB.from_min_max_unchecked(mn, mx)


def _trim(aux, cap: int):
    """``aux`` with every per-row column cut to ``cap`` rows; 0-d values
    (the run tables' ``num_runs``, ``input_truncated``) pass."""
    if isinstance(aux, dict):
        return {k: _trim(v, cap) for k, v in aux.items()}
    if isinstance(aux, tuple):
        return tuple(_trim(v, cap) for v in aux)
    return aux if aux.ndim == 0 else aux[:cap]


def _check_run_tables(aux: Dict, fetched: List[int], when: str) -> None:
    for (n, rt), runs in zip(aux.get("mode_runs", {}).items(), fetched):
        if runs > rt["values"].shape[0]:
            raise AssertionError(
                f"mode run table for {n!r} overflowed {when} ({runs} > "
                f"{rt['values'].shape[0]}) — capacity schedule bug")


def streaming_voxel_downsample(path: Union[str, Path], leaf_size,
                               chunk_points: int = 1 << 20,
                               grid_bits: int = 20,
                               semantics: str = "floor",
                               with_aux: bool = False,
                               bounds: Optional[AABB] = None,
                               use_metadata_bounds: bool = False,
                               schema: Optional[PointSchema] = None,
                               device: Optional[Union[str, torch.device]]
                               = None,
                               **voxel_kwargs):
    """Voxel-downsample a file larger than device memory — EXACTLY.

    Two-stage: each chunk voxelizes against a common grid origin with merge
    statistics (``with_aux``), and an on-device accumulator folds each
    chunk in with :func:`~pasture_tpu_torch.ops.merge_voxel_batches`.  The
    result equals the one-shot global voxelization: for the mean / max
    policies (weighted mean of partial means / max of maxes; integer mean
    columns may differ by one unit of the final integer cast), and for mode
    EXACTLY with ``mode_runs=True`` (each chunk's full per-(voxel, value)
    histogram rides the fold) or, by default, within the top-2 weighted
    vote's envelope (ops/voxel_merge.py).

    The loop never round-trips point data through the host: partial
    voxelizations stay on the device, and the accumulator's capacity grows
    geometrically.  Its voxel count (and run counts) are read to the host
    only when the points-seen bound says the capacity might overflow
    (``HOST_SYNCS`` counts those reads).

    Extra ``voxel_kwargs`` (e.g. ``sort_tiles``, ``mode_runs``,
    ``policies``) forward to :func:`~pasture_tpu_torch.ops.voxel_downsample`.
    A file of ONE chunk keeps that chunk's result as it is: with
    ``sort_tiles > 1`` one row per (tile, voxel), as ``voxel_downsample``
    documents.

    ``with_aux``: also return the accumulated merge statistics (the
    ``(batch, aux)`` form).  ``bounds`` / ``use_metadata_bounds``: the grid
    origin is the cloud minimum, which by default costs a streaming pass
    over the file; pass an :class:`~pasture_tpu_torch.math.AABB` (or trust
    the file header's bounds, which the LAS spec requires to be exact) to
    skip it.  ``device=None`` means the GPU.

    Example — chunked streaming equals one-shot voxelization:

    >>> import numpy as np, os, tempfile
    >>> from pasture_tpu_torch.buffers.host import HostPointBuffer
    >>> from pasture_tpu_torch.io import write_all
    >>> from pasture_tpu_torch.io.streaming import streaming_voxel_downsample
    >>> from pasture_tpu_torch.layout import attributes as att
    >>> from pasture_tpu_torch.layout.schema import PointSchema
    >>> rng = np.random.default_rng(0)
    >>> buf = HostPointBuffer.from_columns(
    ...     PointSchema.from_attributes([att.POSITION_3D]),
    ...     {att.POSITION_3D.name:
    ...          np.round(rng.uniform(0, 8, (4000, 3)), 3)})
    >>> path = os.path.join(tempfile.mkdtemp(), "cloud.las")
    >>> write_all(buf, path)
    >>> out = streaming_voxel_downsample(path, 1.0, chunk_points=1024,
    ...                                  use_metadata_bounds=True,
    ...                                  device="cpu")
    >>> int(out.count)                       # 8^3 cells, all occupied
    512
    """
    from ..ops.voxel import voxel_downsample
    from ..ops.voxel_merge import merge_voxel_batches

    dev = resolve_device(device)
    if bounds is None and use_metadata_bounds:
        with open_reader(path) as reader:
            bounds = reader.get_metadata().bounds()
    if bounds is None:
        bounds = streaming_bounds(path, chunk_points, device=dev)
    if bounds is None:
        raise ValueError("empty input")
    gmin = torch.tensor(np.asarray(bounds.min, np.float32), device=dev)
    policies = voxel_kwargs.get("policies")

    acc = None
    acc_cap = chunk_points
    seen = 0                 # host-known upper bound on accumulated voxels
    for batch in stream_batches(path, chunk_points, schema=schema,
                                device=dev):
        part = voxel_downsample(batch, leaf_size, bounds=(gmin, None),
                                semantics=semantics, grid_bits=grid_bits,
                                with_aux=True, **voxel_kwargs)
        seen += chunk_points
        if acc is None:
            acc = part
            continue
        # geometric capacity schedule: grow only when the points-seen bound
        # says the capacity might overflow, and then size by the TRUE voxel
        # count.  Run tables share it: total runs <= total points, and each
        # chunk adds <= chunk_points runs, so sizing by the larger of
        # (voxels, runs) keeps the fold truncation-free; the run counts are
        # read in the same fetch, so the invariant (runs fit the current
        # table) is checked right here
        if seen > acc_cap:
            tables = acc[1].get("mode_runs", {})
            fetched = torch.stack(
                [acc[0].count] + [rt["num_runs"].to(torch.int32)
                                  for rt in tables.values()]).tolist()
            HOST_SYNCS["streaming_voxel_downsample"] += 1
            _check_run_tables(acc[1], fetched[1:], "mid-fold")
            nv = max(fetched)
            want = chunk_points
            while want < nv + chunk_points:
                want <<= 1
            # never beyond the merged length (slicing can't pad)
            acc_cap = min(want, acc_cap + chunk_points)
            seen = nv + chunk_points
        b, a = merge_voxel_batches([acc, part], policies=policies,
                                   mode_runs_cap=acc_cap)
        # valid voxels form a prefix and rows past it carry the invalid key
        # / zero counts, so cutting to acc_cap >= the count loses nothing
        acc = (PointBatch({n: c[:acc_cap] for n, c in b.data.items()},
                          b.count, b.schema, b.meta, b.policy),
               _trim(a, acc_cap))
    if acc is None:
        raise ValueError("empty input")
    # backstop for the invariant checked at each growth (runs <= points <=
    # seen <= acc_cap), after the last growth
    tables = acc[1].get("mode_runs", {})
    if tables:
        fetched = torch.stack([rt["num_runs"].to(torch.int32)
                               for rt in tables.values()]).tolist()
        HOST_SYNCS["streaming_voxel_downsample"] += 1
        _check_run_tables(acc[1], fetched, "its capacity")
    return acc if with_aux else acc[0]
