"""Algorithm library tour: bounds, voxel downsample, RANSAC, hull, normals,
reprojection.

Port of examples/algorithms_tour.py to pasture_tpu_torch; RANSAC and the
normals run on the device.

Usage: python examples/torch/algorithms_tour.py [--device cpu]
"""

import argparse

import numpy as np

from pasture_tpu_torch.algorithms import (
    Projection,
    calculate_bounds,
    compute_normals,
    convex_hull_as_points,
    ransac_plane_device,
    voxelgrid_filter,
)
from pasture_tpu_torch.buffers.device import PointBatch
from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.schema import PointSchema


def main(device=None):
    rng = np.random.default_rng(1)
    # a tilted plane + noise
    xy = rng.uniform(-10, 10, (2000, 2))
    z = 0.3 * xy[:, 0] - 0.1 * xy[:, 1] + 2.0
    plane = np.stack([xy[:, 0], xy[:, 1], z], axis=1)
    noise = rng.uniform(-15, 15, (300, 3))
    pos = np.concatenate([plane, noise])

    schema = PointSchema.from_attributes([att.POSITION_3D])
    buffer = HostPointBuffer.from_columns(schema,
                                          {att.POSITION_3D.name: pos})

    print("bounds:", calculate_bounds(buffer))

    down = voxelgrid_filter(buffer, 1.0)
    print(f"voxel downsample: {len(buffer)} -> {len(down)} points")

    batch = PointBatch.from_host(buffer, device=device)
    model, inliers = ransac_plane_device(batch, 0.05, 128)
    normal = np.asarray([model.a, model.b, model.c])
    print(f"RANSAC plane: {model.ranking} inliers, "
          f"normal ~ {np.round(normal / np.linalg.norm(normal), 3)}")

    hull = convex_hull_as_points(buffer)
    print("convex hull vertices:", len(hull))

    normals, curvature = compute_normals(buffer, 8, device=device)
    on_plane = float(np.abs(normals[:2000, 2]).mean())
    print("mean |nz| on plane points:", on_plane)

    proj = Projection("EPSG:4326", "EPSG:32632")
    utm = proj.transform(np.array([9.0, 50.0, 0.0]))
    print("UTM of (9E, 50N):", utm)
    return {"inliers": model.ranking, "hull": len(hull),
            "nz": on_plane, "utm": utm}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    main(parser.parse_args().device)
