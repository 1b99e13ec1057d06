"""Casts and schema conversion on device.

The device counterpart of pasture's attribute conversion
(reference: pasture-core/src/layout/conversion/attribute_conversion.rs:188-264)
and of its ``BufferLayoutConverter`` (buffer_conversion.rs:98-450):
Rust-``as`` cast semantics on whole columns and whole
:class:`~pasture_tpu_torch.buffers.device.PointBatch` es, plus the two forms
a u32 word takes in this package.

u32 words (Morton keys, packed payload words, residual words):

* **carrier** form — an ``int64`` tensor holding 0..2**32-1.  Every plain
  PyTorch path computes on this form (torch has no ``uint32`` arithmetic
  on the CPU).
* **bits** form — an ``int32`` tensor holding the same 32 bits.  The CUDA
  kernels read and write this form (4-byte streams) and compare it as
  unsigned.

Functions that accept a u32 word accept either form and convert at their
edge with :func:`u32_carrier` / :func:`u32_bits`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..buffers.device import PointBatch
from ..layout.dtypes import DevicePolicy, torch_carrier
from ..layout.schema import PointSchema

__all__ = ["rust_as_cast_device", "convert_batch_schema", "wrap_to_logical",
           "u32_carrier", "u32_bits"]


def u32_carrier(x: torch.Tensor) -> torch.Tensor:
    """u32 word in either form -> int64 carrier (0..2**32-1)."""
    if x.dtype == torch.int64:
        return x
    if x.dtype == torch.int32:
        return x.to(torch.int64) & 0xFFFFFFFF
    raise TypeError(f"u32 word must be int64 (carrier) or int32 (bits), "
                    f"got {x.dtype}")


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """u32 word in either form -> int32 bit pattern (what the kernels
    take).  int64 -> int32 narrowing wraps, which is exactly the bit
    pattern."""
    if x.dtype == torch.int32:
        return x
    if x.dtype == torch.int64:
        return x.to(torch.int32)
    raise TypeError(f"u32 word must be int64 (carrier) or int32 (bits), "
                    f"got {x.dtype}")


def wrap_to_logical(x: torch.Tensor, dst) -> torch.Tensor:
    """Integer tensor -> carrier of the logical integer dtype ``dst`` with C
    wrap-around (``numpy.astype`` semantics for int -> int)."""
    dst = np.dtype(dst)
    bits = dst.itemsize * 8
    v = x.to(torch.int64)
    if bits < 64:
        v = v & ((1 << bits) - 1)
        if dst.kind == "i":
            sb = 1 << (bits - 1)
            v = (v ^ sb) - sb
    return v.to(torch_carrier(dst))


def rust_as_cast_device(x: torch.Tensor, dst) -> torch.Tensor:
    """Rust ``as`` cast on device to the logical dtype ``dst`` (returned in
    its carrier): int->int wraps, float->int truncates toward zero +
    saturates (NaN -> 0), int->float rounds — matching
    attribute_conversion.rs:188-264 like the host
    :func:`~pasture_tpu_torch.layout.conversion.rust_as_cast`.

    An integer ``x`` is read as its carrier's value (a u16 column in int32
    holds 0..65535).  A column already of type ``dst`` is returned as it
    is, as the reference does."""
    dst = np.dtype(dst)
    if x.dtype == getattr(torch, dst.name, None):
        return x
    if dst.kind == "f":
        return x.to(torch_carrier(dst))
    if x.dtype.is_floating_point:
        info = np.iinfo(dst)
        t = torch.trunc(x)
        t = torch.where(torch.isnan(t), torch.zeros_like(t), t)
        t = torch.clamp(t, float(info.min), float(info.max))
        # float(info.max) may round up past the type (2**31 for i32): clamp
        # again as integers so the last step never overflows
        lo = max(int(info.min), -(1 << 63))
        hi = min(int(info.max), (1 << 63) - 1)
        return torch.clamp(t.to(torch.int64), lo, hi).to(torch_carrier(dst))
    return wrap_to_logical(x, dst)


def convert_batch_schema(batch: PointBatch, to_schema: PointSchema,
                         policy: DevicePolicy = DevicePolicy.NARROW,
                         fill_missing_with_default: bool = False,
                         rename: Optional[Dict[str, str]] = None
                         ) -> PointBatch:
    """Convert a batch to another schema on its device.

    Name-matched columns cast with ``as`` semantics to the target dtype
    under ``policy`` (:func:`rust_as_cast_device`); with
    ``fill_missing_with_default`` absent targets are zero-filled
    (``for_layouts_with_default`` parity); ``rename`` maps target attribute
    name -> source column name (custom mappings).  The count stays on the
    device."""
    rename = rename or {}
    data = {}
    for member in to_schema.members:
        src_name = rename.get(member.name, member.name)
        if src_name in batch.data:
            data[member.name] = rust_as_cast_device(
                batch.data[src_name], policy.np_dtype(member.dtype))
        elif fill_missing_with_default:
            shape = (batch.capacity,) + member.dtype.np_shape
            data[member.name] = torch.zeros(
                shape, dtype=policy.torch_dtype(member.dtype),
                device=batch.device)
        else:
            raise ValueError(
                f"target attribute {member.name!r} has no source column "
                f"(use fill_missing_with_default to zero-fill)")
    return PointBatch(data, batch.count, to_schema, batch.meta, policy)
