"""High-level registration pipeline: scans in, map + trajectory out.

Port of pasture_tpu/pipeline.py: device voxel downsampling, scan-to-keyframe
ICP odometry and a keyframed pose graph in one object.

    pipe = RegistrationPipeline(voxel_size=0.2)
    for scan in scans:                       # HostPointBuffer or (N,3) array
        pipe.add_scan(scan)
    pipe.optimize()
    traj = pipe.trajectory()                 # (K, 3) translations
    map_pts = pipe.map_points()              # merged, downsampled map

Point clouds go to the device as float32 relative to an f64 anchor taken on
the host; the pose graph, a few poses, is solved in float64 on the same
device.  With a mesh (``RegistrationPipeline(mesh=...)``) the alignments
run distributed over its ranks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from ._device import resolve_device
from .buffers.device import PointBatch
from .buffers.host import HostPointBuffer
from .layout import attributes as att
from .layout.schema import PointSchema
from .registration import PoseGraph, icp, optimize_pose_graph
from .registration.se3 import transform_points

__all__ = ["RegistrationPipeline"]


def _positions(scan) -> np.ndarray:
    if isinstance(scan, HostPointBuffer):
        return scan.get_converted(att.POSITION_3D)
    return np.asarray(scan, np.float64).reshape(-1, 3)


@dataclasses.dataclass
class _Keyframe:
    points: np.ndarray        # local-frame positions (downsampled), f64
    rotation: np.ndarray      # world pose
    translation: np.ndarray


class RegistrationPipeline:
    """Incremental scan registration with keyframing.

    Each added scan is aligned to the previous keyframe's points with ICP
    (point-to-plane by default); a new keyframe is spawned when the motion
    exceeds ``keyframe_distance`` or rotates.  :meth:`optimize` runs the
    pose graph over the odometry chain plus any loop closures added with
    :meth:`add_loop_closure`.  ``device=None`` means the GPU.

    Example — three scans of one scene taken 0.1 m apart recover a 0.2 m
    trajectory:

    >>> import numpy as np
    >>> from pasture_tpu_torch.pipeline import RegistrationPipeline
    >>> rng = np.random.default_rng(0)
    >>> scene = rng.uniform(0, 5, (512, 3))
    >>> pipe = RegistrationPipeline(voxel_size=0.25,
    ...                             keyframe_distance=0.05,
    ...                             icp_iterations=8, device="cpu")
    >>> for shift in (0.0, 0.1, 0.2):
    ...     pipe.add_scan(scene + np.asarray([shift, 0.0, 0.0]))
    >>> traj = pipe.trajectory()
    >>> len(traj)
    3
    >>> bool(abs(np.linalg.norm(traj[2] - traj[0]) - 0.2) < 0.02)
    True
    """

    def __init__(self, voxel_size: float = 0.1,
                 max_correspondence_distance: float = 1.0,
                 icp_iterations: int = 20,
                 keyframe_distance: float = 0.5,
                 point_to_plane: bool = True,
                 mesh=None, distributed_halo: int = 512,
                 distributed_capacity_factor: float = 4.0,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        """``mesh`` (opt-in distributed mode): a mesh of
        :func:`pasture_tpu_torch.parallel.make_mesh` or
        :func:`~pasture_tpu_torch.parallel.global_mesh`, of any number of
        axes with a ``"points"`` axis, on whose device the pipeline then
        runs; the alignment is sharded over ``"points"`` and replicated
        over the other axes, as in the reference.  Every rank builds the pipeline and feeds
        it the same scans; scan-to-keyframe alignment runs
        :func:`~pasture_tpu_torch.parallel.distributed_icp_partitioned`
        (both clouds Morton-partitioned, ``distributed_halo`` boundary rows
        exchanged, ``distributed_capacity_factor`` the partition's budget)
        instead of single-device :func:`icp`, and raises if a partition
        dropped points.  Poses come back the same on every rank."""
        if mesh is not None and device is not None \
                and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.voxel_size = voxel_size
        self.max_corr = max_correspondence_distance
        self.icp_iterations = icp_iterations
        self.keyframe_distance = keyframe_distance
        self.point_to_plane = point_to_plane
        self.mesh = mesh
        self.distributed_halo = distributed_halo
        self.distributed_capacity_factor = distributed_capacity_factor
        self.keyframes: List[_Keyframe] = []
        self._edges: List[tuple] = []     # (i, j, rel_rot, rel_t)

    def _f32(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def _f64(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(
            self.device)

    # ---- ingest ---------------------------------------------------------------
    def _downsample(self, pos: np.ndarray) -> np.ndarray:
        """Device voxel-grid downsample, centroid (mean) policy, grid
        anchored at the cloud minimum with ``floor`` binning.  The device
        sees f32 coordinates relative to the f64 minimum: at survey
        magnitudes (~1e6) absolute f32 would quantise centroids to ~0.1 m."""
        if self.voxel_size <= 0 or len(pos) == 0:
            return pos
        from .ops import voxel_downsample
        schema = PointSchema.from_attributes([att.POSITION_3D])
        cap = max(-(-len(pos) // 8) * 8, 8)
        anchor = pos.min(axis=0)
        rel = np.pad(pos - anchor[None, :], [(0, cap - len(pos)), (0, 0)])
        col = self._f32(rel)
        batch = PointBatch({att.POSITION_3D.name: col},
                           torch.tensor(len(pos), dtype=torch.int32,
                                        device=self.device), schema, {})
        out = voxel_downsample(batch, self.voxel_size,
                               bounds=(torch.zeros(3, dtype=col.dtype,
                                                   device=self.device), None),
                               semantics="floor")
        n = int(out.count.item())
        return out.data[att.POSITION_3D.name][:n].cpu().numpy().astype(
            np.float64) + anchor[None, :]

    def _batch(self, pos: np.ndarray) -> PointBatch:
        """This rank's shard of a position cloud (padded to 8 rows)."""
        from .parallel import shard_batch
        schema = PointSchema.from_attributes([att.POSITION_3D])
        cap = max(-(-len(pos) // 8) * 8, 8)
        col = self._f32(np.pad(pos, [(0, cap - len(pos)), (0, 0)]))
        return shard_batch(PointBatch(
            {att.POSITION_3D.name: col},
            torch.tensor(len(pos), dtype=torch.int32, device=self.device),
            schema, {}), self.mesh)

    def _align(self, src: np.ndarray, tgt: np.ndarray):
        """One scan-to-keyframe ICP — single-device, or the partitioned
        distributed ICP when a mesh was given — on coordinates relative to
        the f64 target minimum A; the true translation is
        ``t' + A - R @ A``.  Returns ``(rotation, translation)`` as f64
        numpy."""
        anchor = np.asarray(tgt, np.float64).min(axis=0)
        src_a = np.asarray(src, np.float64) - anchor
        tgt_a = np.asarray(tgt, np.float64) - anchor
        if self.mesh is None:
            result = icp(self._f32(src_a), self._f32(tgt_a),
                         max_correspondence_distance=self.max_corr,
                         iterations=self.icp_iterations,
                         point_to_plane=self.point_to_plane)
        else:
            from .parallel import distributed_icp_partitioned
            result, dropped = distributed_icp_partitioned(
                self._batch(src_a), self._batch(tgt_a), self.mesh,
                halo=self.distributed_halo,
                capacity_factor=self.distributed_capacity_factor,
                max_correspondence_distance=self.max_corr,
                iterations=self.icp_iterations,
                point_to_plane=self.point_to_plane)
            if int(dropped) != 0:
                raise RuntimeError(
                    f"distributed partitioning dropped {int(dropped)} "
                    f"points — raise capacity_factor / rebalance the "
                    f"partition")
        rot = result.rotation.cpu().numpy().astype(np.float64)
        t = result.translation.cpu().numpy().astype(np.float64)
        return rot, t + anchor - rot @ anchor

    def add_scan(self, scan: Union[HostPointBuffer, np.ndarray]) -> None:
        pos = self._downsample(_positions(scan))
        if not self.keyframes:
            self.keyframes.append(_Keyframe(pos, np.eye(3), np.zeros(3)))
            return
        ref = self.keyframes[-1]
        rel_rot, rel_t = self._align(pos, ref.points)
        if np.linalg.norm(rel_t) >= self.keyframe_distance or \
                np.trace(rel_rot) < 3.0 - 1e-3:
            rot = ref.rotation @ rel_rot
            t = ref.rotation @ rel_t + ref.translation
            k = len(self.keyframes)
            self.keyframes.append(_Keyframe(pos, rot, t))
            self._edges.append((k - 1, k, rel_rot, rel_t))

    def add_loop_closure(self, i: int, j: int,
                         rel_rotation: Optional[np.ndarray] = None,
                         rel_translation: Optional[np.ndarray] = None
                         ) -> None:
        """Add an edge between keyframes i and j.  Without an explicit
        measurement, ICP aligns keyframe j's points to keyframe i's."""
        if rel_rotation is None or rel_translation is None:
            rel_rotation, rel_translation = self._align(
                self.keyframes[j].points, self.keyframes[i].points)
        self._edges.append((i, j, rel_rotation, rel_translation))

    # ---- solve ----------------------------------------------------------------
    def graph(self) -> PoseGraph:
        if not self._edges:
            raise ValueError("need at least two keyframes with an edge")
        return PoseGraph(
            rotations=self._f64(np.stack([k.rotation
                                          for k in self.keyframes])),
            translations=self._f64(np.stack([k.translation
                                             for k in self.keyframes])),
            edges=torch.tensor([[e[0], e[1]] for e in self._edges],
                               dtype=torch.int64, device=self.device),
            rel_rotations=self._f64(np.stack([e[2] for e in self._edges])),
            rel_translations=self._f64(np.stack([e[3]
                                                 for e in self._edges])))

    def optimize(self, iterations: int = 10) -> np.ndarray:
        """Pose-graph solve; updates keyframe poses, returns the cost curve."""
        optimized, costs = optimize_pose_graph(self.graph(),
                                               iterations=iterations)
        rots = optimized.rotations.cpu().numpy()
        ts = optimized.translations.cpu().numpy()
        for k, kf in enumerate(self.keyframes):
            kf.rotation = rots[k]
            kf.translation = ts[k]
        return costs.cpu().numpy()

    # ---- outputs --------------------------------------------------------------
    def trajectory(self) -> np.ndarray:
        return np.stack([kf.translation for kf in self.keyframes])

    def map_points(self) -> np.ndarray:
        """All keyframe points in the world frame, voxel-merged."""
        world = [transform_points(self._f64(kf.rotation),
                                  self._f64(kf.translation),
                                  self._f64(kf.points)).cpu().numpy()
                 for kf in self.keyframes]
        return self._downsample(np.concatenate(world))
