"""K9 — LAS point records decoded into a batch's columns on the card.

:func:`las_records_decode` takes a chunk of ``n`` records as the file holds
them (``record_size`` bytes each, a flat uint8 tensor) and writes rows
``[row, row + n)`` of the output columns: the position, ``float64(x) *
scale + offset`` with the product and the sum each rounded on their own,
then rounded to the column's float32 (or kept as float64), and each
pass-through field copied, its components zero-extended where the column's
carrier is wider than the wire's (u16 in int32, u32 in int64).  That is the
host's converting read (``io/las/reader.py``'s fused plan) followed by
``PointBatch.from_host``, so a batch decoded here equals the host path's
bit for bit.

Replaces no TPU kernel: the JAX package decodes LAS on the host.  It was
added so that ``parallel.sharded_read_all`` moves a rank's raw records to
the card through pinned staging and decodes them there.

Bound on the H100: bytes, ``n * (record_size + the columns' bytes a row)``
(:func:`record_bytes`; the sheet's format 6 into float32 positions, int32
intensity and uint8 class: 30 + 12 + 4 + 1 = 47 B a record) at 3.35 TB/s.
Design (``csrc/las_decode.cu``): a block stages a tile of up to 256
records (a multiple of 16, so every tile starts on a 16-byte boundary) in
shared memory with coalesced 16-byte loads, takes each record's fields out
of shared memory, and stores each column coalesced (the positions staged
again, so the block writes them as one contiguous run).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build

__all__ = ["las_records_decode", "las_records_decode_plain", "record_bytes",
           "supports_record_size", "LAUNCHES"]

#: launches of the kernel on CUDA tensors
LAUNCHES = {"las_records_decode": 0}

MAX_FIELDS = 16
_SMEM, _PAD, _MIN_ROWS = 49152, 16, 16
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

#: one pass-through field: (byte offset in the record, bytes of a wire
#: component, the output column (capacity,) or (capacity, components))
Field = Tuple[int, int, torch.Tensor]


def supports_record_size(record_size: int) -> bool:
    """Whether the kernel takes records of ``record_size`` bytes: at least
    16 of them and their float64 positions fit a block's 48 KB of shared
    memory (any LAS record up to 3 047 bytes)."""
    return 12 <= record_size \
        and (_SMEM - _PAD) // (record_size + 24) >= _MIN_ROWS


def record_bytes(n: int, record_size: int,
                 positions: Optional[torch.Tensor],
                 fields: Sequence[Field]) -> int:
    """Bytes the kernel must move for ``n`` records: each record read once,
    each output element written once."""
    out = 0 if positions is None else 3 * positions.element_size()
    for _, _, col in fields:
        out += col.element_size() * (1 if col.ndim == 1 else col.shape[1])
    return n * (record_size + out)


def _check(records, n, record_size, row, pos_offset, positions, fields):
    """What the kernel takes; raises ``ValueError`` on anything else."""
    if records.dtype != torch.uint8 or records.ndim != 1 \
            or not records.is_contiguous():
        raise ValueError("records must be a contiguous flat uint8 tensor")
    if n < 0 or row < 0:
        raise ValueError(f"n={n} and row={row} must be >= 0")
    if not supports_record_size(record_size):
        raise ValueError(f"record_size={record_size} is not taken")
    if records.numel() < n * record_size:
        raise ValueError(f"{records.numel()} bytes hold fewer than {n} "
                         f"records of {record_size}")
    cols = [] if positions is None else [positions]
    if positions is not None:
        if positions.dtype not in (torch.float32, torch.float64) \
                or positions.ndim != 2 or positions.shape[1] != 3:
            raise ValueError("positions must be float32 or float64 (cap, 3)")
        if not 0 <= pos_offset <= record_size - 12:
            raise ValueError(f"pos_offset={pos_offset} outside the record")
    if len(fields) > MAX_FIELDS:
        raise ValueError(f"at most {MAX_FIELDS} fields, got {len(fields)}")
    for offset, comp, col in fields:
        k = 1 if col.ndim == 1 else col.shape[1]
        if comp not in _SIGNED or col.ndim not in (1, 2):
            raise ValueError(f"a field's component is 1, 2, 4 or 8 bytes "
                             f"into a (cap,) or (cap, k) column, got {comp}")
        if not 0 <= offset <= record_size - k * comp:
            raise ValueError(f"field at {offset} outside the record")
        o = col.element_size()
        if o < comp or (o > comp and (col.dtype.is_floating_point
                                      or col.dtype == torch.bool)):
            raise ValueError(f"a {comp}-byte component cannot go into "
                             f"{col.dtype}")
        cols.append(col)
    for col in cols:
        if col.device != records.device or not col.is_contiguous():
            raise ValueError("every column must be contiguous on the "
                             "records' device")
        if row + n > col.shape[0]:
            raise ValueError(f"rows [{row}, {row + n}) past a column of "
                             f"{col.shape[0]}")


def las_records_decode_plain(records: torch.Tensor, n: int,
                             record_size: int, row: int,
                             scale: Sequence[float],
                             offset: Sequence[float], pos_offset: int,
                             positions: Optional[torch.Tensor],
                             fields: Sequence[Field]) -> None:
    """Plain version of :func:`las_records_decode`, equal to the kernel
    bit for bit."""
    _check(records, n, record_size, row, pos_offset, positions, fields)
    rec = records[:n * record_size].view(n, record_size)
    dev = records.device
    if positions is not None:
        local = rec[:, pos_offset:pos_offset + 12].contiguous().view(
            torch.int32)
        s = torch.tensor(list(scale), dtype=torch.float64, device=dev)
        o = torch.tensor(list(offset), dtype=torch.float64, device=dev)
        positions[row:row + n] = (local.to(torch.float64) * s + o).to(
            positions.dtype)
    for off, comp, col in fields:
        k = 1 if col.ndim == 1 else col.shape[1]
        raw = rec[:, off:off + k * comp].contiguous().view(_SIGNED[comp])
        if col.element_size() > comp:
            raw = raw.to(col.dtype) & ((1 << 8 * comp) - 1)
        else:
            raw = raw.view(col.dtype)
        col[row:row + n] = raw.reshape((n,) + tuple(col.shape[1:]))


def las_records_decode(records: torch.Tensor, n: int, record_size: int,
                       row: int, scale: Sequence[float],
                       offset: Sequence[float], pos_offset: int,
                       positions: Optional[torch.Tensor],
                       fields: Sequence[Field]) -> None:
    """Decode ``n`` records of ``record_size`` bytes (``records``, flat
    uint8) into rows ``[row, row + n)`` of ``positions`` (float32 or
    float64 (cap, 3), from the int32 locals at ``pos_offset``, ``scale``
    and ``offset`` of the file; ``None`` for none) and of each field's
    column (:data:`Field`).

    On CUDA tensors the kernel, on the current stream (``records`` 16-byte
    aligned and readable to the next multiple of 16 bytes past ``n *
    record_size``, else ``ValueError``); on CPU tensors the plain
    version."""
    if not records.is_cuda:
        las_records_decode_plain(records, n, record_size, row, scale, offset,
                                 pos_offset, positions, fields)
        return
    _check(records, n, record_size, row, pos_offset, positions, fields)
    if records.data_ptr() % 16 or \
            records.numel() < -(-n * record_size // 16) * 16:
        raise ValueError("records must be 16-byte aligned and hold whole "
                         "16-byte words")
    if n == 0:
        return
    kind = 0 if positions is None else (
        1 if positions.dtype == torch.float32 else 2)
    f_out = (ctypes.c_longlong * MAX_FIELDS)(
        *[col.data_ptr() for _, _, col in fields])
    f_meta = (ctypes.c_int * (4 * MAX_FIELDS))(
        *[v for off, comp, col in fields
          for v in (off, comp, 1 if col.ndim == 1 else col.shape[1],
                    col.element_size())])
    s, o = [float(v) for v in scale], [float(v) for v in offset]
    lib = _build.library("las_decode")
    with torch.cuda.device(records.device):
        code = lib.las_decode_launch(
            records.data_ptr(), n, record_size, row, *s, *o, pos_offset, kind,
            None if positions is None else positions.data_ptr(), len(fields),
            f_out, f_meta, _build.stream())
    _build.check(code, "las_records_decode")
    LAUNCHES["las_records_decode"] += 1
