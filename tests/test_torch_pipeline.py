"""RegistrationPipeline of the port against the JAX package, and a CPU
rehearsal of the normals and registration paths of ``chip_smoke.py``."""

import functools
import types

import jax
import numpy as np
import pytest
import torch

import pasture_tpu.ops as jops
import pasture_tpu.pipeline as jpipeline
from pasture_tpu.registration import IcpResult as JIcpResult
from pasture_tpu.registration import icp as jicp

import chip_smoke
from pasture_tpu_torch.ops import kernels
from pasture_tpu_torch.pipeline import RegistrationPipeline


@functools.lru_cache(maxsize=None)
def _jit_icp(static):
    def run(source, target):
        r = jicp(source, target, **dict(static))
        return r.rotation, r.translation, r.rmse, r.num_inliers
    return jax.jit(run)


def _jax_icp(source, target, **kw):
    rot, t, rmse, nin = _jit_icp(tuple(sorted(kw.items())))(source, target)
    return JIcpResult(rot, t, rmse, nin, kw["iterations"])


@pytest.fixture
def jitted_reference(monkeypatch):
    """The JAX pipeline with its two device calls, ``voxel_downsample`` and
    ``icp``, each under one ``jax.jit`` (as the JAX package's own
    io/streaming.py and tests/test_ops.py run ``voxel_downsample``): the
    same functions, compiled once per shape instead of op by op."""
    jds = jax.jit(jops.voxel_downsample,
                  static_argnames=("leaf_size", "semantics"))
    monkeypatch.setattr(jops, "voxel_downsample",
                        lambda b, leaf, **kw: jds(b, leaf_size=leaf, **kw))
    monkeypatch.setattr(jpipeline, "icp", _jax_icp)
    return jpipeline.RegistrationPipeline


def test_pipeline_matches_jax(rng, jitted_reference):
    """The three-scan example of the JAX pipeline's docstring: trajectory
    within 1e-5 m of JAX's and the merged map equal to JAX's within 1e-5 m
    (the JAX pipeline runs in f64 here, the port's device clouds are f32
    relative to an f64 anchor: 5 m of extent in f32 is ~5e-7 m)."""
    scene = rng.uniform(0, 5, (512, 3))
    kw = dict(voxel_size=0.25, keyframe_distance=0.05, icp_iterations=8)
    pipe = RegistrationPipeline(**kw, device="cpu")
    ref = jitted_reference(**kw)
    for shift in (0.0, 0.1, 0.2):
        scan = scene + np.asarray([shift, 0.0, 0.0])
        pipe.add_scan(scan)
        ref.add_scan(scan)
    traj = pipe.trajectory()
    assert len(traj) == 3
    np.testing.assert_allclose(traj, ref.trajectory(), atol=1e-5)
    assert abs(np.linalg.norm(traj[2] - traj[0]) - 0.2) < 0.02
    got, want = pipe.map_points(), ref.map_points()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pipeline_mesh_mode_is_not_ported():
    """The name dates from when the mesh mode raised; the mode is ported
    now (``tests/test_torch_distributed.py`` drives it over four ranks),
    and the test keeps its name.  Here: the pipeline takes the mesh's device
    and the reference's defaults, refuses a ``device=`` other than the
    mesh's, and a graph needs an edge."""
    mesh = types.SimpleNamespace(device=torch.device("cpu"))
    pipe = RegistrationPipeline(mesh=mesh)
    assert pipe.device == mesh.device and pipe.mesh is mesh
    assert (pipe.distributed_halo, pipe.distributed_capacity_factor) == \
        (512, 4.0)
    with pytest.raises(ValueError, match="mesh"):
        RegistrationPipeline(mesh=mesh, device="meta")
    with pytest.raises(ValueError, match="two keyframes"):
        RegistrationPipeline(device="cpu").graph()


def test_smoke_normals_and_icp_paths_on_the_cpu():
    """The smoke script's normals and ICP paths at a small size through the
    same functions: Morton normals (K6's plain version, no launch on the
    CPU) and Morton ICP on both objectives."""
    pos = chip_smoke.normals_surface(1 << 14)
    nrm, curv = chip_smoke.path_normals(chip_smoke.positions_buffer(pos),
                                        device="cpu")
    assert nrm.shape == (1 << 14, 3) and np.isfinite(curv).all()
    # a sparse cloud: the share within 6° is far below the 2M-point gate
    assert chip_smoke.within_degrees(nrm, pos) > 0.5

    source, target = chip_smoke.icp_pair(1 << 12)
    src, tgt = torch.from_numpy(source), torch.from_numpy(target)
    for p2pl in (False, True):
        kernels.reset_launch_counts()
        res = chip_smoke.path_icp(src, tgt, p2pl, iterations=6)
        assert chip_smoke.icp_residual(res, source, target) < 0.02
        assert kernels.launch_counts()["window_fit_moments"] == 0


def test_smoke_registration_path_on_the_cpu():
    """The smoke script's registration path at 2048 points a scan: four
    keyframes 0.1 m apart; knocked 2° and 5 cm off their odometry poses,
    the pose graph (dense through ``optimize()``, and CG) brings them back
    within 1e-6 with the cost falling by 1e-12 or more; the compaction of
    one scan's downsampling equals its plain version; a loop closure
    measured by ICP agrees with the chain."""
    scans = chip_smoke.registration_scans(n=1 << 11)
    pipe, odometry, knocked, cost0, costs = chip_smoke.path_registration(
        scans, device="cpu", icp_iterations=6)
    assert len(pipe.keyframes) == chip_smoke.REG_SCANS
    assert chip_smoke.trajectory_error(odometry[1]) < 0.02
    assert cost0 > 1e-3
    cg_graph, cg_costs = chip_smoke.optimize_pose_graph(knocked, solver="cg")
    for curve, rots, ts in (
            (costs, np.stack([kf.rotation for kf in pipe.keyframes]),
             pipe.trajectory()),
            (cg_costs.numpy(), cg_graph.rotations.numpy(),
             cg_graph.translations.numpy())):
        assert np.all(np.diff(np.concatenate([[cost0], curve])) <= 1e-12)
        assert curve[-1] <= 1e-12 * cost0
        assert chip_smoke.pose_error(rots, ts, odometry) < 1e-6
    assert chip_smoke.held_compaction(scans[0], device="cpu") > 0
    pipe.add_loop_closure(0, 3)
    assert len(pipe.graph().edges) == 4
    assert pipe.optimize()[-1] < 1e-9
    np.testing.assert_allclose(pipe.trajectory(), odometry[1], atol=1e-4)
