"""Operations and bytes of the voxel step's hand kernels, from shapes.

Each input byte is counted once as read and each output byte once as
written, whatever a kernel reads again; the same counts hold whatever
implements the step, so a kernel fused or replaced later is judged on the
same work.  The step's four kernels are bound by bytes (a handful of
integer and float operations a point against 20-28 bytes).

``n`` is the rows a kernel is launched over (the batch's capacity; K1 the
valid rows it reads).  Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet,
at the full 700 W power limit.
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: kernel -> the names its launches carry in a device trace: K3's wrapper
#: launches ``voxel_reduce`` and then ``pt_zero_tail``, which writes the
#: rows past the voxel count that K3's bytes count
KERNEL_NAMES = {"K1": ("world_bounds",), "K2": ("voxel_head_exact_local",),
                "K4": ("tile_sort_kernel",),
                "K3": ("voxel_reduce", "pt_zero_tail")}


def k1_world_bounds(n: int) -> int:
    """(n, 3) int32 locals read; six float32 bounds written."""
    return 12 * n + 24


def k2_exact_local_head(n: int) -> int:
    """(n, 3) int32 locals read; a key and a residual word written."""
    return 12 * n + 8 * n


def k4_tile_sort(n: int, streams: int) -> int:
    """``streams`` 32-bit streams read and written."""
    return 2 * 4 * streams * n


def k3_voxel_reduce(n: int) -> int:
    """Key, word and residual word read; (n, 3) float32 centroids and an
    output word written (rows past the voxel count too), and the count."""
    return 12 * n + 16 * n + 4


def step_bytes(n_valid: int, capacity: int) -> Dict[str, int]:
    """Bytes of each kernel of one exact-local step (K4 with 3 streams)."""
    return {"K1": k1_world_bounds(n_valid),
            "K2": k2_exact_local_head(capacity),
            "K4": k4_tile_sort(capacity, 3),
            "K3": k3_voxel_reduce(capacity)}


def bound_seconds(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time the card could take: bytes over its memory rate or
    operations over its float32 rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)
