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
every output row (kept or zeroed) written once.  Design
(``csrc/compact.cu``): one pass.  A block of 2048 rows, taken by ticket,
first issues the 16-byte copies of its rows of every column (raw bytes, so
one kernel serves every dtype and ``(N, C)`` columns) into shared memory,
and while they are in flight reads its mask once (16 flags per 16-byte
load), ranks its kept rows by popcounts and a scan, and takes its global
offset from a decoupled look-back over the blocks before it (status words
in a small zeroed scratch).  Then every kept row goes from shared memory
to offset + rank.  The last block writes the kept count, which stays on
the device; a second small launch zeroes the output rows past it, so the
outputs come from ``torch.empty``.  Columns share a launch while they fit
(:func:`launch_groups`); further launches take the offsets the first one
published, and spread each block's parts over several blocks of threads.
A row wider than a launch takes (``LAUNCH_ROW_BYTES``) goes through the
kernel as byte slices of its row (:func:`column_slices`), each slice a
column of its own with the full row as its pitch, staged a row a slot so
that its 16-byte copies still line up; the first launch of such a call
only ranks, so that every slice's launch is a spread one.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build

__all__ = ["blockwise_compact", "blockwise_compact_plain", "LAUNCHES",
           "ROWS_PER_BLOCK", "MAX_COLS_PER_LAUNCH", "LAUNCH_ROW_BYTES",
           "SLICE_BYTES", "launch_groups", "column_slices", "staged_bytes"]

#: launches of the kernel: one per call that compacts on the GPU (its write
#: launches and zero-tail launches together)
LAUNCHES = {"blockwise_compact": 0}

ROWS_PER_BLOCK = 2048       # CP_ROWS of csrc/compact.cu
MAX_COLS_PER_LAUNCH = 8     # CP_MAX_COLS
LAUNCH_ROW_BYTES = 36864 - 32 * MAX_COLS_PER_LAUNCH   # CP_SLAB less padding
#: widest byte slice of a wider row: a multiple of 16 whose slot
#: (:func:`staged_bytes`) fits a launch
SLICE_BYTES = LAUNCH_ROW_BYTES - 16


def staged_bytes(row_bytes: int, pitch: int) -> int:
    """Shared-memory bytes a row of a column takes in a launch: the row
    itself where rows are contiguous (``pitch == row_bytes``), else a
    16-aligned slot that holds the row at its own offset mod 16
    (``cp_slot_bytes`` of ``csrc/compact.cu``)."""
    return row_bytes if pitch == row_bytes else (row_bytes + 30) // 16 * 16


def column_slices(row_bytes: int) -> List[Tuple[int, int]]:
    """``(byte offset, bytes)`` of the slices a row of ``row_bytes`` goes
    through the kernel in: the whole row where it fits a launch, else
    ``ceil(row_bytes / SLICE_BYTES)`` slices of an even share rounded up to
    16 bytes (so no slice is much narrower than half a launch), the last
    one narrower."""
    if row_bytes <= LAUNCH_ROW_BYTES:
        return [(0, row_bytes)]
    k = -(-row_bytes // SLICE_BYTES)
    width = (-(-row_bytes // k) + 15) // 16 * 16
    out = [(i * width, min(width, row_bytes - i * width)) for i in range(k)]
    assert out[-1][1] > 0 and all(w <= SLICE_BYTES for _, w in out)
    return out


def launch_groups(row_bytes: Sequence[int]) -> List[List[int]]:
    """The columns (by index) of each write launch: in order, a new launch
    when the next column would pass ``MAX_COLS_PER_LAUNCH`` columns or
    ``LAUNCH_ROW_BYTES`` bytes of a row.  A wider row raises."""
    groups: List[List[int]] = []
    width = 0
    for i, rb in enumerate(row_bytes):
        if rb > LAUNCH_ROW_BYTES:
            raise ValueError(f"rows of at most {LAUNCH_ROW_BYTES} bytes, "
                             f"got {rb}")
        if not groups or len(groups[-1]) == MAX_COLS_PER_LAUNCH \
                or width + rb > LAUNCH_ROW_BYTES:
            groups.append([])
            width = 0
        groups[-1].append(i)
        width += rb
    return groups


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


def _unit_of(row_bytes: int, *ptrs_and_pitches: int) -> int:
    """Widest of 8, 4, 2, 1 bytes that divides the row and every address
    and pitch."""
    for unit in (8, 4, 2):
        if row_bytes % unit == 0 and all(p % unit == 0
                                         for p in ptrs_and_pitches):
            return unit
    return 1


def blockwise_compact(cols: Sequence[torch.Tensor], keep: torch.Tensor
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Compact ``cols`` (each ``(N,)`` or ``(N, ...)``, any dtype) so rows
    with ``keep`` (``(N,)`` bool) move to the front in order.  Returns
    (compacted columns, kept count as a 0-d int32 tensor on the columns'
    device — no host read).  Rows at or past the count are zero.

    On CUDA tensors the kernel runs, for rows of any width; on CPU
    tensors the plain version."""
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
    live = [(s, o) for s, o in zip(srcs, outs) if s.numel()]
    if not live:                 # no column has a byte to move
        return outs, keep.sum().to(torch.int32)
    # (source, destination, row bytes, pitch) of every column the kernel
    # moves: a row too wide for a launch as its byte slices
    parts = []
    for s, o in live:
        width = s.numel() // n * s.element_size()
        parts += [(s.data_ptr() + at, o.data_ptr() + at, nb, width)
                  for at, nb in column_slices(width)]
    groups = launch_groups([staged_bytes(nb, pitch)
                            for _, _, nb, pitch in parts])
    if any(nb != pitch for _, _, nb, pitch in parts):
        # a first launch that only ranks: every launch that moves a slice
        # then spreads its blocks' parts over the card
        groups.insert(0, [])
    blocks = (n + ROWS_PER_BLOCK - 1) // ROWS_PER_BLOCK
    # the ticket and the blocks' status words: the call's only memset
    status = torch.zeros(blocks + 1, dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    lib = _build.library("compact")
    with torch.cuda.device(dev):
        for g, group in enumerate(groups):
            k = len(group)
            chosen = [parts[i] for i in group]
            src = (ctypes.c_void_p * k)(*[c[0] for c in chosen])
            dst = (ctypes.c_void_p * k)(*[c[1] for c in chosen])
            row_bytes = (ctypes.c_int * k)(*[c[2] for c in chosen])
            pitch = (ctypes.c_int * k)(*[c[3] for c in chosen])
            unit = (ctypes.c_int * k)(*[_unit_of(nb, p, s, d)
                                        for s, d, nb, p in chosen])
            # the sources and destinations share their pitch
            code = lib.compact_launch(
                keep8.data_ptr(), n, blocks, status.data_ptr(),
                total.data_ptr(), int(g > 0), k, src, dst, row_bytes, pitch,
                pitch, unit, _build.stream())
            _build.check(code, "blockwise_compact")
    LAUNCHES["blockwise_compact"] += 1
    return outs, total
