"""Device compute ops over :class:`~pasture_tpu_torch.buffers.PointBatch`.

Plain functions on tensors that follow their inputs' device; the hand-written
CUDA kernels live in :mod:`pasture_tpu_torch.ops.kernels`.
"""

from .compact import compact_columns  # noqa: F401
from .convert import (  # noqa: F401
    convert_batch_schema, rust_as_cast_device, u32_bits, u32_carrier)
from .filter import compact_batch, filter_batch  # noqa: F401
from .reductions import (  # noqa: F401
    batch_bounds, masked_max, masked_min, masked_minmax, segment_max,
    segment_mean, segment_min, segment_mode, segment_sum)
from .sort import morton_sort, sort_by_keys  # noqa: F401
from .transform import (  # noqa: F401
    affine_transform, decode_las_positions, encode_las_positions,
    transform_positions)
from .voxel import voxel_downsample, voxel_indices  # noqa: F401
from .voxel_merge import merge_voxel_batches  # noqa: F401
