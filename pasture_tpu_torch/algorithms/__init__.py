"""Point-cloud algorithm library (parity: pasture-algorithms).

User-facing functions mirroring the reference's public surface
(reference: pasture-algorithms/src/lib.rs:7-23).  Ported so far: bounds,
minmax, voxel-grid downsampling and normals — each device-first on top of
:mod:`pasture_tpu_torch.ops`, with host-exact (f64 numpy) paths where bit
parity with the reference matters.
"""

from .bounds import calculate_bounds  # noqa: F401
from .minmax import minmax_attribute  # noqa: F401
from .normals import (  # noqa: F401
    compute_centroid, compute_normals, knn_indices)
from .voxel_grid import voxelgrid_filter  # noqa: F401
