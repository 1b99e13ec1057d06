"""Order-preserving stream compaction, as a contract.

Moves rows where ``keep`` is True to the front, preserving order, and
returns the kept count: an inclusive ``cumsum`` of ``keep`` gives every
kept row its destination, and one scatter writes it there.

Reference semantics mirrored: order-preserving predicate filtering
(pasture-core/src/containers/point_buffer.rs:1030-1120 ``filter``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["compact_columns"]


def compact_columns(cols: Sequence[torch.Tensor], keep: torch.Tensor
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Compact ``cols`` (each ``(N,)`` or ``(N, C)``) so rows with ``keep``
    move to the front in order.  Returns (compacted columns, kept count as
    a 0-d int32 tensor).  Rows past the kept count are zero."""
    n = keep.shape[0]
    rank = torch.cumsum(keep.to(torch.int64), dim=0)
    count = (rank[-1] if n else rank.sum()).to(torch.int32)
    # dropped rows all land in one spare slot past the end
    dest = torch.where(keep, rank - 1, torch.full_like(rank, n))
    out = []
    for c in cols:
        buf = c.new_zeros((n + 1,) + tuple(c.shape[1:]))
        buf.index_copy_(0, dest, c)
        out.append(buf[:n])
    return out, count
