"""CPU rehearsals of ``chip_smoke.py``'s at-scale phases at small sizes —
the exact normals gate, the pose-graph sweep and the closed trajectory —
and the sweep's circle graph solved by the port and by the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest

from pasture_tpu import registration as jreg

import chip_smoke
from pasture_tpu_torch.algorithms import normals


@pytest.fixture(scope="module")
def circle64():
    """The bench's circle graph at 64 poses, and JAX's dense solve of it in
    f64 (the port's dense and CG solves are both held to it)."""
    graph, _ = chip_smoke.circle_graph(64, device="cpu")
    jgraph = jreg.PoseGraph(
        rotations=jnp.asarray(graph.rotations.numpy()),
        translations=jnp.asarray(graph.translations.numpy()),
        edges=jnp.asarray(graph.edges.numpy(), jnp.int32),
        rel_rotations=jnp.asarray(graph.rel_rotations.numpy()),
        rel_translations=jnp.asarray(graph.rel_translations.numpy()))
    jopt, _ = jreg.optimize_pose_graph(jgraph,
                                       iterations=chip_smoke.POSE_ITERS)
    return graph, np.asarray(jopt.translations)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_circle_graph_matches_jax(circle64, solver):
    """The port's solve of the circle graph against JAX's within 1e-6 m."""
    graph, want = circle64
    opt, _ = chip_smoke.optimize_pose_graph(
        graph, iterations=chip_smoke.POSE_ITERS, solver=solver,
        **(chip_smoke.POSE_CG_KW if solver == "cg" else {}))
    np.testing.assert_allclose(opt.translations.numpy(), want, atol=1e-6)
    assert graph.num_edges == 63 + 21


def test_pose_graph_gate_on_the_cpu():
    """The sweep's gates at 64 poses: costs fall, ATE below the start,
    dense and CG on the same graph within 1e-6 m."""
    runs, gap = chip_smoke.gate_pose_graph(dense=(64,), cg=(64,),
                                           device="cpu", agree_at=64)
    assert [r["solver"] for r in runs] == ["dense", "cg"]
    assert gap <= 1e-6
    for r in runs:
        assert r["ate_m"] < r["ate_start_m"]
        assert len(r["costs"]) == chip_smoke.POSE_ITERS


def test_trajectory_poses_close_the_loop():
    """32 scans ~0.196 m apart on a 1 m circle, yaw 3° sin; fewer scans keep
    the step on a smaller loop; each scan is the scene in its own frame."""
    rot, t = chip_smoke.trajectory_poses(32)
    steps = np.linalg.norm(np.diff(np.concatenate([t, t[:1]]), axis=0),
                           axis=1)
    np.testing.assert_allclose(steps, 2 * np.sin(np.pi / 32), rtol=1e-12)
    np.testing.assert_allclose(np.einsum("nji,njk->nik", rot, rot),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-12)
    for scans in (8, 16):
        r8, t8 = chip_smoke.trajectory_poses(scans)
        step = np.linalg.norm(t8[1] - t8[0])
        assert abs(step - steps[0]) < 0.005
    scan = chip_smoke.trajectory_scan(5, (rot, t), n=4096)
    world = chip_smoke.scene_points(
        np.random.default_rng(18), 4096, -32.0, 32.0,
        ((0, -16.0), (0, 16.0), (1, -16.0), (1, 16.0)),
        chip_smoke.TRAJ_WALL_YAW_DEG)
    np.testing.assert_allclose(scan @ rot[5].T + t[5], world, atol=1e-12)


def test_trajectory_gate_on_the_cpu():
    """The trajectory phase at 6 scans of 8 192 points on a 10 m tile (the
    step of the full loop: radius 0.2 m, yaw 0.6°), 10 ICP iterations:
    every gate of ``gate_trajectory``, and K5's inputs captured."""
    poses = chip_smoke.trajectory_poses(6, radius=0.2, yaw_deg=0.6)
    scans = [chip_smoke.trajectory_scan(i, poses, n=8192, size=10.0)
             for i in range(6)]
    pipe, odometry, costs, sec = chip_smoke.path_trajectory(
        scans, device="cpu", icp_iterations=10)
    gate = chip_smoke.gate_trajectory(pipe, poses, 6)
    assert gate["mean_m"] <= chip_smoke.TRAJ_MEAN_M
    assert len(sec["downsample"]) == 6 and len(sec["icp"]) == 6
    assert costs[-1] <= costs[0]
    assert chip_smoke.pose_errors(*odometry, poses)["worst_m"] < 0.05
    assert chip_smoke.held_compaction(scans[0], device="cpu") > 0


def test_exact_normals_gate_on_the_cpu(monkeypatch):
    """The exact normals phase's gates at 20 000 points with the gather
    cap and the query slice shrunk so the CPU runs the scan: the kd-tree
    oracle, certified = exhaustive on three tiles, and the card-against-CPU
    comparison's arithmetic (CPU against CPU here)."""
    monkeypatch.setattr(normals, "_EXACT_NORMALS_MAX", 4096)
    monkeypatch.setattr(normals, "_EXACT_SLICE", 8192)
    pos = chip_smoke.normals_surface(20_000)
    nrm, curv = chip_smoke.exact_normals(pos, "cpu")
    gate = chip_smoke.gate_normals_exact(pos, nrm, curv)
    assert gate["oracle_points"] == 5000
    cert = chip_smoke.check_certified(pos, "cpu", tiles=3)
    assert cert["tiles"][0] == 0 and cert["tiles"][-1] == 7
    assert sum(cert["certified_visits"]) < sum(cert["exhaustive_visits"])
    cross = chip_smoke.cross_check_exact(5000, "cpu")
    assert cross["within_1deg"] == 1.0
