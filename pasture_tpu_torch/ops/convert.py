"""Casts on device.

The device counterpart of pasture's attribute conversion
(reference: pasture-core/src/layout/conversion/attribute_conversion.rs:188-264):
Rust-``as`` cast semantics on whole columns, plus the two forms a u32 word
takes in this package.

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

import numpy as np
import torch

from ..layout.dtypes import torch_carrier

__all__ = ["rust_as_cast_device", "wrap_to_logical", "u32_carrier",
           "u32_bits"]


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
    holds 0..65535)."""
    dst = np.dtype(dst)
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
