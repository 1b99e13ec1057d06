"""Morton (Z-order) coding — the spatial key underlying sorting, voxel
grids and multi-host map-block partitioning.

Generalises pasture's bit tricks (reference:
pasture-core/src/math/bitmanip.rs:2-41 — ``expand_bits_by_3`` spreads 21-bit
coords into a 63-bit interleave; ``reverse_bits`` via LUT) into vectorised
host (numpy, u64) and device (torch, dual-u32) forms.  On device a u32
word is an int64 tensor holding 0..2**32-1 (the carrier of
pasture_tpu_torch.layout.dtypes.CARRIER_OF).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "expand_bits_by_3", "reverse_bits", "morton_encode_u64",
    "morton_encode_dual32", "morton_decode_u32", "morton_key_f32",
]


def expand_bits_by_3(x) -> np.ndarray:
    """Spread the low 21 bits of ``x`` so each lands 3 positions apart
    (bitmanip.rs:2-10 semantics, vectorised)::

        >>> hex(int(expand_bits_by_3(0b111)))
        '0x49'
        >>> int(morton_encode_u64(1, 0, 0)), int(morton_encode_u64(0, 1, 0))
        (1, 2)
    """
    v = np.asarray(x, dtype=np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


_REV_LUT = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8)


def reverse_bits(x) -> np.ndarray:
    """Bit-reverse each u64 (bitmanip.rs:13-41 LUT approach, vectorised)."""
    v = np.asarray(x, dtype=np.uint64)
    out = np.zeros_like(v)
    for byte in range(8):
        b = (v >> np.uint64(8 * byte)) & np.uint64(0xFF)
        out |= _REV_LUT[b.astype(np.int64)].astype(np.uint64) << np.uint64(8 * (7 - byte))
    return out


def morton_encode_u64(ix, iy, iz) -> np.ndarray:
    """Host 63-bit Morton code from 21-bit per-axis cell indices.

    Bit order matches the classic x|y<<1|z<<2 interleave."""
    return (expand_bits_by_3(ix)
            | (expand_bits_by_3(iy) << np.uint64(1))
            | (expand_bits_by_3(iz) << np.uint64(2)))


# ---- device (torch; u32 words as int64 carriers) ------------------------------

def _expand10_u32(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of a u32 word 3 apart (classic magic numbers)."""
    v = v.to(torch.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact10_u32(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_expand10_u32`: gather every 3rd bit back into the
    low 10 bits."""
    v = v.to(torch.int64) & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x3FF
    return v


def morton_decode_u32(key: torch.Tensor):
    """(ix, iy, iz) 10-bit cell indices from a 30-bit single-word Morton
    key (the ``grid_bits <= 10`` voxel-key layout in ops/voxel.py)."""
    key = key.to(torch.int64)
    return (_compact10_u32(key), _compact10_u32(key >> 1),
            _compact10_u32(key >> 2))


def morton_encode_dual32(ix: torch.Tensor, iy: torch.Tensor,
                         iz: torch.Tensor):
    """60-bit Morton code as a (hi, lo) pair of u32 words from 20-bit cell
    indices.

    hi interleaves bits 10..19 of each axis, lo interleaves bits 0..9; the
    pair sorts lexicographically identically to the u64 code.
    """
    ix = ix.to(torch.int64)
    iy = iy.to(torch.int64)
    iz = iz.to(torch.int64)
    lo = (_expand10_u32(ix) | (_expand10_u32(iy) << 1) | (_expand10_u32(iz) << 2))
    hi = (_expand10_u32(ix >> 10) | (_expand10_u32(iy >> 10) << 1)
          | (_expand10_u32(iz >> 10) << 2))
    return hi, lo


def morton_key_f32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One float64 key, ``hi * 2**30 + lo``, from a dual-u32 Morton pair
    (either u32 form: int64 carrier or int32 bits).  Exact while the code
    fits f64's 53-bit mantissa; sorting by both words is the exact order.
    Kept for host-side convenience, as in the reference."""
    def value(w):
        return w.to(torch.int64) & 0xFFFFFFFF
    return value(hi).to(torch.float64) * float(1 << 30) \
        + value(lo).to(torch.float64)
