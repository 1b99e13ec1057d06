"""Position transforms on device.

The device analog of pasture's LAS position decode/encode
(reference: pasture-io/src/las/raw_readers.rs:39-58 and
write_helpers.rs:10-24) and of the per-point
coordinate transforms that the reference runs through PROJ or nalgebra.
All ops are elementwise over SoA columns.

Precision model: world positions on device are f32 *relative to a per-batch
anchor*.  Decoding LAS i32 local coords against the anchor loses nothing:
``(local - local_anchor) * scale`` stays within f32's 24-bit mantissa for any
realistic tile extent, which is the same trick the LAS format itself uses.

The 3x3 product is written as explicit sums, not as a matmul, so that its
float32 result never depends on the TF32 switches of the matmul backend.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["decode_las_positions", "encode_las_positions",
           "affine_transform", "transform_positions"]

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def decode_las_positions(local: torch.Tensor, scale: torch.Tensor,
                         offset: torch.Tensor,
                         anchor: Optional[torch.Tensor] = None,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """i32 local coords -> world positions (raw_readers.rs:39-50 semantics).

    With ``anchor`` (i32 local-space anchor, e.g. the batch min), positions
    are returned relative to the anchor in ``dtype``: exact in f32 for
    realistic extents.  Without it, the absolute position is computed in
    ``dtype`` directly (lossy in f32 for large UTM-style offsets).
    """
    if anchor is not None:
        rel = (local - anchor[None, :]).to(dtype)
        return rel * scale.to(dtype)[None, :]
    return local.to(dtype) * scale.to(dtype)[None, :] \
        + offset.to(dtype)[None, :]


def encode_las_positions(world: torch.Tensor, scale: torch.Tensor,
                         offset: Optional[torch.Tensor] = None,
                         anchor: Optional[torch.Tensor] = None,
                         rounding: str = "trunc") -> torch.Tensor:
    """World -> i32 local coords, in ``world``'s float dtype.
    ``rounding="trunc"`` truncates toward zero (write_helpers.rs:10-24
    ``as i64`` parity, minus the range panic — out-of-range values
    saturate); ``"round"`` rounds half to even, which makes decode ->
    encode an exact bit round trip.  With ``anchor`` (i32), the result is
    relative to it and the anchor is added back (wrapping)."""
    if rounding not in ("trunc", "round"):
        raise ValueError(f"rounding must be 'trunc' or 'round', got "
                         f"{rounding!r}")
    w = world
    if offset is not None:
        w = w - offset[None, :].to(w.dtype)
    q = w / scale[None, :].to(w.dtype)
    q = torch.trunc(q) if rounding == "trunc" else torch.round(q)
    # clipped in the float dtype, where the i32 max may round up (to 2**31
    # in f32); the integer clip then saturates as the reference's cast does
    q = torch.clamp(q, float(_I32_MIN), float(_I32_MAX)).to(torch.int64)
    q = torch.clamp(q, _I32_MIN, _I32_MAX).to(torch.int32)
    if anchor is not None:
        q = q + anchor[None, :].to(torch.int32)
    return q


def affine_transform(positions: torch.Tensor, matrix: torch.Tensor,
                     translation: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``p @ M^T + t`` over an (N, 3) column.  A 3x3 ``matrix`` (+optional
    translation) or a 4x4 homogeneous matrix are accepted."""
    if tuple(matrix.shape) == (4, 4):
        translation = matrix[:3, 3]
        matrix = matrix[:3, :3]
    m = matrix.to(positions.dtype)
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    out = torch.stack([m[a, 0] * x + m[a, 1] * y + m[a, 2] * z
                       for a in range(3)], dim=1)
    if translation is not None:
        out = out + translation[None, :].to(positions.dtype)
    return out


def transform_positions(positions: torch.Tensor, rotation: torch.Tensor,
                        translation: torch.Tensor) -> torch.Tensor:
    """Rigid SE(3) transform — the ICP/pose-graph building block."""
    return affine_transform(positions, rotation, translation)
