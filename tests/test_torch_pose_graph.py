"""The pose graph of the port against the JAX package: both solvers in f64
on a noisy odometry circle with loop closures, carried across by
``interop.pose_graph_from_reference``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu import registration as jreg

from pasture_tpu_torch import interop
from pasture_tpu_torch.registration import (PoseGraph, optimize_pose_graph,
                                            se3_exp, se3_log, so3_exp)
from pasture_tpu_torch.registration.pose_graph import edge_residuals


def _circle_graph(rng, n_poses, drift=0.05, rot_noise=0.05):
    """numpy arrays of a noisy odometry circle with loop closures to pose 0
    and perturbed initial rotations (the reference tests' graph)."""
    angles = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    true_t = np.stack([np.cos(angles), np.sin(angles),
                       np.zeros(n_poses)], axis=1) * 5.0
    edges, rel_t = [], []
    for i in range(n_poses - 1):
        edges.append([i, i + 1])
        rel_t.append(true_t[i + 1] - true_t[i] + rng.normal(0, drift, 3))
    for i in range(3, n_poses, 3):
        edges.append([i, 0])
        rel_t.append(true_t[0] - true_t[i])
    est_t = np.cumsum(np.concatenate([true_t[:1], rel_t[:n_poses - 1]]),
                      axis=0)
    rots = so3_exp(torch.from_numpy(
        rng.normal(0, rot_noise, (n_poses, 3)))).numpy()
    e = len(edges)
    return (rots, est_t, np.asarray(edges, np.int32),
            np.broadcast_to(np.eye(3), (e, 3, 3)).copy(), np.stack(rel_t),
            rng.uniform(0.5, 2.0, e))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_optimize_pose_graph_matches_jax(rng, solver):
    """Both solvers in f64 against JAX: poses within 1e-9, costs within
    1e-9 relative; the graph crosses over through interop."""
    arrays = _circle_graph(rng, 24)
    graph = interop.pose_graph_from_reference(*arrays, device="cpu")
    jgraph = jreg.PoseGraph(*[jnp.asarray(a) for a in arrays])
    kw = dict(iterations=6, solver=solver, cg_iterations=300, cg_tol=1e-10)
    opt, costs = optimize_pose_graph(graph, **kw)
    jopt, jcosts = jreg.optimize_pose_graph(jgraph, **kw)
    back = interop.pose_graph_to_reference(opt)
    np.testing.assert_allclose(back[0], np.asarray(jopt.rotations),
                               atol=1e-9)
    np.testing.assert_allclose(back[1], np.asarray(jopt.translations),
                               atol=1e-9)
    np.testing.assert_array_equal(back[2], arrays[2])
    np.testing.assert_array_equal(back[5], arrays[5])
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts),
                               rtol=1e-9, atol=1e-12)
    assert float(costs[-1]) < 0.05 * float(
        (edge_residuals(graph) ** 2 * graph.weights[:, None]).sum())


def test_pose_graph_validation_and_defaults(rng):
    arrays = _circle_graph(rng, 6)
    graph = interop.pose_graph_from_reference(*arrays[:5], device="cpu")
    assert graph.weights is None and graph.num_poses == 6
    assert interop.pose_graph_to_reference(graph)[5] is None
    with pytest.raises(ValueError, match="unknown solver"):
        optimize_pose_graph(graph, solver="qr")
    opt, costs = optimize_pose_graph(graph, iterations=0)
    assert costs.shape == (0,) and opt.rotations is graph.rotations
    assert isinstance(opt, PoseGraph)


def test_jacobian_at_identity_is_finite():
    """Forward-mode derivative of log(exp(x)) at 0, where the solver takes
    its Jacobians: the identity, finite."""
    jac = torch.func.jacfwd(lambda x: se3_log(*se3_exp(x)))(
        torch.zeros(6, dtype=torch.float64))
    np.testing.assert_allclose(jac.numpy(), np.eye(6), atol=1e-12)
