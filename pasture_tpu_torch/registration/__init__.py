"""Scan registration: ICP + pose graph.

Port of pasture_tpu/registration: ICP scan-to-map alignment (brute-force or
Morton-window correspondences, point-to-point or point-to-plane) and a
keyframed pose graph solved by Gauss-Newton (dense Cholesky or
block-sparse PCG).
"""

from .se3 import (  # noqa: F401
    se3_exp,
    se3_log,
    so3_exp,
    so3_log,
    transform_points,
)
from .icp import icp, IcpResult  # noqa: F401
from .pose_graph import PoseGraph, optimize_pose_graph  # noqa: F401
