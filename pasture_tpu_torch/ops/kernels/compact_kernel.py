"""Stable stream compaction — the filter step and the voxel path's key
compaction.

Moves the rows of several columns where ``keep`` is set to the front, in
order, and counts them.  The output is compacted GLOBALLY and rows at or
past the count are zero.

Replaces: pasture_tpu/ops/kernels/compact_kernel.py blockwise_compact_pallas
(_make_kernel), together with the merge of its per-block outputs
(ops/compact.py _merge_tiles).  The TPU kernel moves rows by a ladder of
power-of-two shifts because that machine has no scatter; a GPU thread
simply writes its row where it belongs, so neither the ladder nor the merge
is carried over.  Bound on the H100: bytes — the mask, every row read once,
every kept row written once.  Design (``csrc/compact.cu``): a first launch
counts kept rows per block of 2048 rows; ``torch.cumsum`` over those few
thousand counts gives each block its global offset; the second launch ranks
each kept row inside its block (warp ballot + a scan of the warp counts in
shared memory) and copies the row of every column — as raw bytes, so one
kernel serves 1-, 2-, 4- and 8-byte types and ``(N, C)`` columns — to
``offset[block] + rank``; it also zeroes the output rows past the total, so
no memset is launched.  Up to eight columns share one write launch.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build

__all__ = ["blockwise_compact", "blockwise_compact_plain", "LAUNCHES",
           "ROWS_PER_BLOCK", "MAX_COLS_PER_LAUNCH"]

#: launches of the kernel: one per call that compacts on the GPU (its count
#: launch and its write launches together)
LAUNCHES = {"blockwise_compact": 0}

ROWS_PER_BLOCK = 2048       # CP_ROWS of csrc/compact.cu
MAX_COLS_PER_LAUNCH = 8     # CP_MAX_COLS


def _check_args(cols: Sequence[torch.Tensor], keep: torch.Tensor) -> int:
    if keep.dtype != torch.bool or keep.ndim != 1:
        raise TypeError(f"keep must be a 1-D bool tensor, got "
                        f"{tuple(keep.shape)} {keep.dtype}")
    n = keep.shape[0]
    if n >= 1 << 31:
        raise ValueError("at most 2**31 - 1 rows per call")
    for c in cols:
        if c.ndim < 1 or c.shape[0] != n or c.device != keep.device:
            raise ValueError("every column needs keep's length and device")
    return n


def blockwise_compact_plain(cols: Sequence[torch.Tensor], keep: torch.Tensor
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of :func:`blockwise_compact`: an inclusive
    ``cumsum`` of ``keep`` gives every kept row its destination, and one
    ``index_copy_`` per column writes it there."""
    n = _check_args(cols, keep)
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


def _unit_of(row_bytes: int, *ptrs: int) -> int:
    """Widest of 8, 4, 2, 1 bytes that divides the row and every address."""
    for unit in (8, 4, 2):
        if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    return 1


def blockwise_compact(cols: Sequence[torch.Tensor], keep: torch.Tensor
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Compact ``cols`` (each ``(N,)`` or ``(N, ...)``, any dtype) so rows
    with ``keep`` (``(N,)`` bool) move to the front in order.  Returns
    (compacted columns, kept count as a 0-d int32 tensor on the columns'
    device — no host read).  Rows at or past the count are zero.

    On CUDA tensors the kernel runs; on CPU tensors the plain version."""
    if not keep.is_cuda:
        return blockwise_compact_plain(cols, keep)
    n = _check_args(cols, keep)
    dev = keep.device
    if n == 0:
        return ([torch.zeros_like(c) for c in cols],
                torch.zeros((), dtype=torch.int32, device=dev))
    keep8 = keep.contiguous().view(torch.uint8)
    srcs = [c.contiguous() for c in cols]
    outs = [torch.empty_like(s) for s in srcs]
    blocks = (n + ROWS_PER_BLOCK - 1) // ROWS_PER_BLOCK
    counts = torch.empty(blocks, dtype=torch.int32, device=dev)
    lib = _build.library("compact")
    with torch.cuda.device(dev):
        code = lib.compact_count_launch(keep8.data_ptr(), n, blocks,
                                        counts.data_ptr(), _build.stream())
        _build.check(code, "blockwise_compact (count)")
        # block offsets: an exclusive scan of 'blocks' integers
        incl = torch.cumsum(counts, 0, dtype=torch.int32)
        offsets = (incl - counts).contiguous()
        total = incl[-1]
        live = [(s, o) for s, o in zip(srcs, outs) if s.numel()]
        for at in range(0, len(live), MAX_COLS_PER_LAUNCH):
            group = live[at:at + MAX_COLS_PER_LAUNCH]
            k = len(group)
            src = (ctypes.c_void_p * k)(*[s.data_ptr() for s, _ in group])
            dst = (ctypes.c_void_p * k)(*[o.data_ptr() for _, o in group])
            units = (ctypes.c_int * k)()
            unit = (ctypes.c_int * k)()
            for i, (s, o) in enumerate(group):
                row_bytes = s.numel() // n * s.element_size()
                unit[i] = _unit_of(row_bytes, s.data_ptr(), o.data_ptr())
                units[i] = row_bytes // unit[i]
            code = lib.compact_write_launch(
                keep8.data_ptr(), n, blocks, offsets.data_ptr(),
                total.data_ptr(), k, src, dst, units, unit, _build.stream())
            _build.check(code, "blockwise_compact (write)")
    LAUNCHES["blockwise_compact"] += 1
    return outs, total
