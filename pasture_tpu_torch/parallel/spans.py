"""Seconds spent in each phase of a sharded fold, cumulative.

The phases of ``sharded_read_all`` and ``sharded_voxel_downsample_merged``:

* ``read`` — on the host clock: every file's header and the rank's row
  plan, and on the host path (``ingest.py``) the host decode of the rank's
  rows;
* ``upload`` — the rows onto the rank's device: on the record path the
  whole pipeline, file -> pinned staging -> device -> K9's decode, from
  before the first file read to after the last decode; on the host path
  ``PointBatch.from_host``.  ``read`` and ``upload`` together cover the
  whole ingest, without overlap;
* ``voxelize`` — stage 1, the rank's own voxelization;
* ``gather`` — the all-gather of every rank's voxel statistics;
* ``merge`` — the exact merge of the gathered statistics.

On a CUDA device the last four are timed by a pair of CUDA events on the
device's current stream, so timing puts no host sync on the path: a pair
is resolved into :data:`SPANS` only when :func:`span_seconds` is read
(which waits for the pairs still pending) or, once it has completed, when
a later pair is recorded.  On the CPU they run on the host clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Tuple

import torch

__all__ = ["PHASES", "SPANS", "span", "span_seconds", "reset_spans"]

PHASES = ("read", "upload", "voxelize", "gather", "merge")
#: seconds of each phase resolved so far (:func:`span_seconds` resolves
#: the pairs still pending first)
SPANS: Dict[str, float] = {p: 0.0 for p in PHASES}
#: CUDA event pairs recorded and not yet resolved, per phase
_PENDING: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {
    p: [] for p in PHASES}


def _resolve(name: str, wait: bool) -> None:
    keep = []
    for a, b in _PENDING[name]:
        if wait or b.query():
            b.synchronize()
            SPANS[name] += a.elapsed_time(b) / 1e3
        else:
            keep.append((a, b))
    _PENDING[name] = keep


@contextlib.contextmanager
def span(name: str, device: torch.device) -> Iterator[None]:
    """Add the block's time to phase ``name``: CUDA events around it on
    ``device``'s current stream, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        yield
        SPANS[name] += time.perf_counter() - t0
        return
    stream = torch.cuda.current_stream(device)
    a = torch.cuda.Event(enable_timing=True)
    a.record(stream)
    yield
    b = torch.cuda.Event(enable_timing=True)
    b.record(stream)
    _resolve(name, wait=False)
    _PENDING[name].append((a, b))


def span_seconds() -> Dict[str, float]:
    """``{phase: seconds}`` since the last :func:`reset_spans`; waits for
    the event pairs still pending."""
    for p in PHASES:
        _resolve(p, wait=True)
    return dict(SPANS)


def reset_spans() -> None:
    """Set every phase to 0 and drop the pairs still pending."""
    for p in PHASES:
        SPANS[p] = 0.0
        _PENDING[p] = []
