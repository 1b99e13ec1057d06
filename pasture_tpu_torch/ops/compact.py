"""Order-preserving stream compaction, as a contract.

Moves rows where ``keep`` is True to the front, preserving order, and
returns the kept count.  On CUDA tensors this IS the hand kernel
(``ops/kernels/compact_kernel.py``); on CPU tensors its plain version.

What the module it is ported from holds beyond that — packing narrow
integer columns into shared words, cumsums built from jump steps or matrix
products, the ladder of staged shifts, the sequential merge of per-tile
blocks — works around a machine without scatter and is not carried over: a
GPU thread writes its row where it belongs.  Two differences in the
contract follow: the result is compacted globally (not per block), and rows
past the kept count are zero (not unspecified).

Reference semantics mirrored: order-preserving predicate filtering
(pasture-core/src/containers/point_buffer.rs:1030-1120 ``filter``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .kernels.compact_kernel import blockwise_compact

__all__ = ["compact_columns"]


def compact_columns(cols: Sequence[torch.Tensor], keep: torch.Tensor,
                    tiles: int = 0
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Compact ``cols`` (each ``(N,)`` or ``(N, C)``, any dtype) so rows
    with ``keep`` move to the front in order.  Returns (compacted columns,
    kept count as a 0-d int32 tensor).  Rows past the kept count are zero.

    ``tiles`` is accepted for the reference's callers and ignored: there it
    picks the TPU's staged-shift schedule, and the port's kernel (K5)
    compacts globally in one pass whatever it is; results do not
    change."""
    return blockwise_compact(cols, keep)
