"""Point-cloud algorithm library (parity: pasture-algorithms).

User-facing functions mirroring the reference's public surface
(reference: pasture-algorithms/src/lib.rs:7-23): bounds, minmax, voxel-grid
downsampling, RANSAC segmentation, convex hull, normal estimation and CRS
reprojection.  Bounds, minmax, voxel grid, normals and the device RANSAC
variants run on the batch's device on top of :mod:`pasture_tpu_torch.ops`;
the serial RANSAC variants, the convex hull and reprojection are host f64
numpy, bit-equal to the JAX package's.
"""

from .bounds import calculate_bounds  # noqa: F401
from .minmax import minmax_attribute  # noqa: F401
from .voxel_grid import voxelgrid_filter  # noqa: F401
from .segmentation import (  # noqa: F401
    Line,
    Plane,
    ransac_line_device,
    ransac_line_par,
    ransac_line_serial,
    ransac_plane_device,
    ransac_plane_par,
    ransac_plane_serial,
)
from .convexhull import (  # noqa: F401
    convex_hull_as_points,
    convex_hull_as_triangle_mesh,
)
from .normals import (  # noqa: F401
    compute_centroid, compute_normals, knn_indices)
from .reprojection import Projection, reproject_point_cloud_between, \
    reproject_point_cloud_within  # noqa: F401
