"""Device-side predicate filtering (prefix compaction).

Counterpart of pasture's ``HashMapBuffer::filter`` / ``filter_into``
(reference pasture-core/src/containers/point_buffer.rs:1030-1120) and the
predicate-filter benchmark dimension
(pasture-core/benches/buffer_filter_bench.rs:71-79): kept rows move to the
front in their order, as the reference's order-preserving filter does.
Every column of the batch goes through one :func:`compact_columns` call —
on the GPU the ``blockwise_compact`` kernel, whole ``(N, C)`` rows at a
time.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..buffers.device import PointBatch
from .compact import compact_columns

__all__ = ["compact_batch", "filter_batch"]


def compact_batch(batch: PointBatch, keep: torch.Tensor) -> PointBatch:
    """Move rows where ``keep`` is True to the front, in order; ``count``
    becomes the number of kept valid rows (a 0-d tensor on the batch's
    device: nothing is read to the host).  ``keep`` is a (capacity,) bool
    tensor; rows past ``batch.count`` are dropped regardless.  Rows past
    the new count are zero."""
    keep = keep & batch.valid_mask()
    names = list(batch.data)
    compacted, new_count = compact_columns([batch.data[n] for n in names],
                                           keep)
    return PointBatch(dict(zip(names, compacted)), new_count, batch.schema,
                      batch.meta, batch.policy)


def filter_batch(batch: PointBatch,
                 predicate: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
                 ) -> PointBatch:
    """Filter by a vectorised predicate over the SoA columns.

    ``predicate`` receives ``batch.data`` (dict of (capacity,[C]) tensors)
    and returns a (capacity,) bool mask — the whole-column analog of the
    reference's per-point ``filter(|point| ...)`` closure."""
    return compact_batch(batch, predicate(batch.data))
