"""The port's distributed registration, normals and pipeline on the CPU,
and a CPU rehearsal of ``chip_smoke.py``'s ``path_distributed`` gates.

One world of four gloo ranks on the CPU (a module fixture) runs every case
(``torch_parallel_ranks.distributed_cases``) and returns numpy.
``distributed_icp`` is held to the JAX package's (f64, make_mesh(4) of the
conftest's virtual devices, under one ``jax.jit``) within 1e-9; every
other entry point to the port's own single-device functions, which are
held to the JAX package elsewhere, by the relations the reference's tests
assert: replicated ICP = ``icp`` within 1e-6; partitioned ICP = ``icp``
within 1e-12 on the diagonal cloud (same inliers), within 5e-3 on the 2-D
manifold, and point-to-plane within 5e-3 of the truth; the dense pose
graph = ``optimize_pose_graph`` within 1e-8 and CG = dense within 1e-6;
``distributed_normals`` > 0.97 within 10° of the exact normals;
``RegistrationPipeline(mesh=)`` = the pipeline without a mesh.  The same
cases run again over ``"points"`` of a ("hosts", "points") mesh of shape
(2, 2) in the same world, held to the same bounds, every result the same
on both ``hosts`` rows.  The rehearsal runs
``chip_smoke.distributed_world`` in the same world at small sizes (its
2-D mesh step included) and ``chip_smoke.gate_distributed`` /
``gate_mesh2d`` on what comes back."""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pasture_tpu.parallel import distributed_icp as j_distributed_icp
from pasture_tpu.parallel import make_mesh as j_make_mesh

import chip_smoke
import torch_parallel_ranks as ranks
from pasture_tpu_torch import algorithms, interop
from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.pipeline import RegistrationPipeline
from pasture_tpu_torch.registration import icp, optimize_pose_graph
from pasture_tpu_torch.parallel.spawn import run_world

SIZE = 4
# the world's ranks stop before the test's own time limit, so a stuck rank
# fails with the ranks named (the world took 94 s on a loaded test run)
WORLD_TIMEOUT_S = 240.0
pytestmark = pytest.mark.time_limit(300)
T_TRUE = np.array([0.1, -0.08, 0.05])
PIPELINE = {"voxel_size": 0.25, "keyframe_distance": 0.05,
            "icp_iterations": 8, "distributed_halo": 64}
REHEARSAL = dict(n=32768, ztiles=8, xtiles=8, scan_n=8192, scene_size=10.0,
                 pipe_scans=3, halo=64, read_n=4096, cross_n=None, icp_iters=10,
                 pose={"dense": 64, "cg": 64, "cg_large": 128},
                 device="cpu", backend=None)


def _manifold(rng, n, scale=3.0):
    u = rng.uniform(-scale, scale, (n, 2))
    z = 0.3 * np.sin(u[:, 0] * 2) + 0.2 * np.cos(u[:, 1] * 1.5)
    return np.stack([u[:, 0], u[:, 1], z], axis=1)


def _rehearsal_inputs(work, cfg):
    """The small world-(b) rehearsal's inputs and references: the main
    path's batch at 32 768 points as f32 world positions, a dense patch of
    the normals surface; ``ready`` written last (the ranks wait for it)."""
    local, inten, cls = chip_smoke.make_columns(cfg["n"], cfg["ztiles"],
                                                cfg["xtiles"])
    batch = chip_smoke.make_batch(local, inten, cls, device="cpu")
    affine = chip_smoke.affine_on("cpu")
    wbatch = chip_smoke.attribute_batch(
        batch, chip_smoke.exact_f32_head(batch, affine)[1])
    rng = np.random.default_rng(3)
    xy = rng.uniform(-12, 12, (20000, 2)).astype(np.float32)
    surface = np.stack([xy[:, 0], xy[:, 1], (
        0.4 * np.sin(xy[:, 0] * 0.7) + 0.3 * np.cos(xy[:, 1] * 0.5)
    ).astype(np.float32)], axis=1)
    refs = chip_smoke.prepare_distributed(work, cfg, wbatch, surface)
    (work / "ready").touch()
    return refs


def _inputs(work) -> tuple:
    rng = np.random.default_rng(42)
    inp = {}
    target = _manifold(rng, 1024)
    inp["icp_target"], inp["icp_source"] = target, target - T_TRUE
    x = rng.uniform(0, 40, 2048)
    diag = np.stack([x, x + 0.3 * np.sin(x * 2.3), x + 0.3 * np.cos(x * 1.7)],
                    axis=1)
    manifold = _manifold(rng, 2048)
    u = rng.uniform(-4, 4, (4096, 2))
    plane = np.stack([u[:, 0], u[:, 1], 0.3 * np.sin(u[:, 0])
                      + 0.2 * np.cos(u[:, 1] * 1.3)], axis=1)
    shift = {"diagonal": T_TRUE, "manifold": T_TRUE,
             "plane": np.array([0.05, -0.04, 0.08])}
    for name, cloud in (("diagonal", diag), ("manifold", manifold),
                        ("plane", plane)):
        inp[f"{name}_target"] = cloud
        inp[f"{name}_source"] = cloud - shift[name]
    inp["partitioned"] = {
        "diagonal": {"halo": 128}, "manifold": {"halo": 256},
        "plane": {"halo": 256, "point_to_plane": True, "normals_k": 10,
                  "normals_window": 48}}
    graphs = {}
    for name, n, kw in (("dense16", 16, {"iterations": 5}),
                        ("dense32", 32, {"iterations": 4}),
                        ("cg32", 32, {"iterations": 4, "solver": "cg",
                                      "cg_iterations": 2000,
                                      "cg_tol": 1e-12})):
        g, _ = chip_smoke.circle_graph(n, device="cpu")
        graphs[name] = (interop.pose_graph_to_reference(g), kw)
    inp["pose_graphs"] = graphs
    xy = rng.uniform(-10, 10, (4096, 2))
    inp["normals"] = np.stack([xy[:, 0], xy[:, 1], 0.4 * np.sin(
        xy[:, 0] * 0.7) + 0.3 * np.cos(xy[:, 1] * 0.5)], axis=1)
    scene = rng.uniform(0, 5, (512, 3))
    inp["scans"] = [scene + np.asarray([s, 0.0, 0.0])
                    for s in (0.0, 0.1, 0.2)]
    inp["pipeline"] = dict(PIPELINE, device="cpu")
    inp["rehearsal"] = (str(work), chip_smoke.dist_config(**REHEARSAL))
    return inp


def _single_side(inp) -> dict:
    """The JAX package's distributed ICP and the port's single-device
    functions on the same inputs."""
    mesh = j_make_mesh(SIZE)
    def run(s, t):
        r = j_distributed_icp(s, t, mesh, max_correspondence_distance=2.0,
                              iterations=10)
        return r.rotation, r.translation, r.num_inliers
    out = {"jax_icp": [np.asarray(x) for x in jax.jit(run)(
        jnp.asarray(inp["icp_source"]), jnp.asarray(inp["icp_target"]))]}
    for name in ("icp", "diagonal", "manifold"):
        src = inp["icp_source" if name == "icp" else f"{name}_source"]
        tgt = inp["icp_target" if name == "icp" else f"{name}_target"]
        out[name] = icp(torch.from_numpy(src), torch.from_numpy(tgt),
                        max_correspondence_distance=2.0, iterations=10)
    for name, (arrays, kw) in inp["pose_graphs"].items():
        if kw.get("solver", "dense") == "dense":
            g = interop.pose_graph_from_reference(*arrays, device="cpu")
            out[name] = optimize_pose_graph(g, **kw)[0]
    schema = PointSchema.from_attributes([att.POSITION_3D])
    out["normals"], _ = algorithms.compute_normals(
        HostPointBuffer.from_columns(schema,
                                     {att.POSITION_3D.name: inp["normals"]}),
        12, method="exact", device="cpu")
    pipe = RegistrationPipeline(**{k: v for k, v in inp["pipeline"].items()
                                   if k != "distributed_halo"})
    for scan in inp["scans"]:
        pipe.add_scan(scan)
    out["pipeline"] = pipe.trajectory()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``(inputs, each rank's results, references, rehearsal config and
    references)``."""
    work = tmp_path_factory.mktemp("distributed")
    inp = _inputs(work)
    cfg = inp["rehearsal"][1]
    with ThreadPoolExecutor(max_workers=1) as ex:
        port = ex.submit(run_world, ranks.distributed_cases, SIZE, (inp,),
                         "cpu", None, WORLD_TIMEOUT_S)
        refs = _rehearsal_inputs(work, cfg)
        single = _single_side(inp)
        return inp, port.result(), single, (cfg, refs)


def _replicated(port, get):
    first = get(port[0])
    for res in port[1:]:
        np.testing.assert_array_equal(get(res), first)
    return first


def test_distributed_icp_matches_jax_and_icp(world):
    _, port, single, _ = world
    t = _replicated(port, lambda r: r["icp"]["translation"])
    rot = _replicated(port, lambda r: r["icp"]["rotation"])
    j_rot, j_t, j_inliers = single["jax_icp"]
    np.testing.assert_allclose(t, j_t, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rot, j_rot, rtol=0, atol=1e-9)
    assert port[0]["icp"]["num_inliers"] == int(j_inliers)
    np.testing.assert_allclose(t, single["icp"].translation.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(rot, single["icp"].rotation.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(t, T_TRUE, atol=5e-3)


@pytest.mark.parametrize("name,atol", (("diagonal", 1e-12),
                                       ("manifold", 5e-3)))
def test_partitioned_icp_matches_icp(world, name, atol):
    _, port, single, _ = world
    t = _replicated(port, lambda r: r[name]["translation"])
    rot = _replicated(port, lambda r: r[name]["rotation"])
    assert port[0][name]["dropped"] == 0
    np.testing.assert_allclose(t, T_TRUE, atol=5e-3)
    np.testing.assert_allclose(t, single[name].translation.numpy(),
                               atol=atol)
    np.testing.assert_allclose(rot, single[name].rotation.numpy(), atol=atol)
    if name == "diagonal":
        assert port[0][name]["num_inliers"] == int(
            single[name].num_inliers)


def test_partitioned_icp_point_to_plane(world):
    _, port, _, _ = world
    t = _replicated(port, lambda r: r["plane"]["translation"])
    assert port[0]["plane"]["dropped"] == 0
    np.testing.assert_allclose(t, [0.05, -0.04, 0.08], atol=5e-3)
    np.testing.assert_allclose(port[0]["plane"]["rotation"], np.eye(3),
                               atol=5e-3)


@pytest.mark.parametrize("name", ("dense16", "dense32"))
def test_pose_graph_dense_matches_single_device(world, name):
    _, port, single, _ = world
    t = _replicated(port, lambda r: r["pose_graph"][name]["translations"])
    np.testing.assert_allclose(t, single[name].translations.numpy(),
                               atol=1e-8)
    np.testing.assert_allclose(
        port[0]["pose_graph"][name]["rotations"],
        single[name].rotations.numpy(), atol=1e-8)


def test_pose_graph_cg_matches_dense(world):
    _, port, _, _ = world
    cg = _replicated(port, lambda r: r["pose_graph"]["cg32"]["translations"])
    dense = port[0]["pose_graph"]["dense32"]
    np.testing.assert_allclose(cg, dense["translations"], atol=1e-6)
    np.testing.assert_allclose(port[0]["pose_graph"]["cg32"]["costs"],
                               dense["costs"], rtol=1e-6, atol=1e-10)


def test_distributed_normals_match_exact(world):
    inp, port, single, _ = world
    _check_normals([r["normals"] for r in port], inp, single)


def _check_normals(shards, inp, single):
    """Shards of ``distributed_normals`` in order: every point once, > 0.97
    of the normals within 10° of the exact ones."""
    pos = np.concatenate([s["pos"] for s in shards])
    nrm = np.concatenate([s["normals"] for s in shards])
    assert not shards[0]["dropped"].any()
    o1, o2 = np.lexsort(pos.T), np.lexsort(inp["normals"].T)
    np.testing.assert_array_equal(pos[o1], inp["normals"][o2])
    cos = np.abs(np.sum(nrm[o1] * single["normals"][o2], axis=1))
    deg = np.degrees(np.arccos(np.clip(cos, 0, 1)))
    assert float((deg < 10).mean()) > 0.97


def test_pipeline_with_mesh_matches_pipeline(world):
    _, port, single, _ = world
    traj = _replicated(port, lambda r: r["pipeline"])
    assert traj.shape == single["pipeline"].shape == (3, 3)
    np.testing.assert_allclose(traj, single["pipeline"], atol=2e-2)
    assert abs(np.linalg.norm(traj[2] - traj[0]) - 0.2) < 0.02


def test_pipeline_raises_when_the_partition_drops(world):
    _, port, _, _ = world
    for res in port:
        assert "dropped" in res["tight"]


def test_collectives_counted(world):
    _, port, _, _ = world
    for res in port:
        c = res["collectives"]
        assert c["all_reduce"]["calls"] > 0 and c["ring"]["calls"] > 0
        assert c["staged"]["to_host_bytes"] == 0


def test_rehearsal_of_the_card_phase_gates(world):
    """``chip_smoke.py``'s ``path_distributed`` at small sizes in the
    world-(b) form (four ranks, gloo): every gate passes, and the steps'
    records are there."""
    _, port, _, (cfg, refs) = world
    ranks_out = [r["rehearsal"] for r in port]
    g = chip_smoke.gate_distributed(ranks_out, refs, cfg)
    assert g["quantized_max_err"] == 0.0
    assert g["normals_within_6deg"] >= 0.99
    line = chip_smoke.world_line(ranks_out, "rehearsal", g, "cpu")
    assert set(line["seconds"]) == set(port[0]["rehearsal"]["launches"])
    assert line["staged_bytes"]["morton_partition_halo"] == 0
    # what the phase prints is JSON
    json.dumps(line)
    json.dumps({"prepare_split": refs["seconds"],
                "icp_points": refs["icp_points"]})


def test_rehearsal_worlds_compare(world):
    """``compare_worlds`` of the rehearsal world against itself and
    against a world whose partition is changed (which it must refuse)."""
    _, port, _, _ = world
    b = [r["rehearsal"] for r in port]
    a = [dict(b[0], partition=dict(b[0]["partition"], pos=np.concatenate(
        [r["partition"]["pos"] for r in b])))]
    agree = chip_smoke.compare_worlds(a, b)
    assert agree["partition_in_the_same_order"]
    json.dumps(agree)
    bad = [dict(a[0], partition=dict(a[0]["partition"],
                                     pos=a[0]["partition"]["pos"][1:]))]
    with pytest.raises(AssertionError):
        chip_smoke.compare_worlds(bad, b)


def _nd(port):
    """Each rank's results over ``"points"`` of the (2, 2) mesh."""
    return [r["nd"] for r in port]


def test_nd_distributed_icp_matches_jax_and_icp(world):
    _, port, single, _ = world
    nd = _nd(port)
    t = _replicated(nd, lambda r: r["icp"]["translation"])
    rot = _replicated(nd, lambda r: r["icp"]["rotation"])
    j_rot, j_t, j_inliers = single["jax_icp"]
    np.testing.assert_allclose(t, j_t, rtol=0, atol=1e-9)
    np.testing.assert_allclose(rot, j_rot, rtol=0, atol=1e-9)
    assert nd[0]["icp"]["num_inliers"] == int(j_inliers)
    np.testing.assert_allclose(t, single["icp"].translation.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("name,atol", (("diagonal", 1e-12),
                                       ("manifold", 5e-3)))
def test_nd_partitioned_icp_matches_icp(world, name, atol):
    _, port, single, _ = world
    nd = _nd(port)
    t = _replicated(nd, lambda r: r[name]["translation"])
    rot = _replicated(nd, lambda r: r[name]["rotation"])
    assert nd[0][name]["dropped"] == 0
    np.testing.assert_allclose(t, T_TRUE, atol=5e-3)
    np.testing.assert_allclose(t, single[name].translation.numpy(),
                               atol=atol)
    np.testing.assert_allclose(rot, single[name].rotation.numpy(), atol=atol)
    if name == "diagonal":
        assert nd[0][name]["num_inliers"] == int(single[name].num_inliers)


def test_nd_partitioned_icp_point_to_plane(world):
    _, port, _, _ = world
    nd = _nd(port)
    t = _replicated(nd, lambda r: r["plane"]["translation"])
    assert nd[0]["plane"]["dropped"] == 0
    np.testing.assert_allclose(t, [0.05, -0.04, 0.08], atol=5e-3)
    np.testing.assert_allclose(nd[0]["plane"]["rotation"], np.eye(3),
                               atol=5e-3)


@pytest.mark.parametrize("name", ("dense16", "dense32"))
def test_nd_pose_graph_dense_matches_single_device(world, name):
    _, port, single, _ = world
    nd = _nd(port)
    t = _replicated(nd, lambda r: r["pose_graph"][name]["translations"])
    np.testing.assert_allclose(t, single[name].translations.numpy(),
                               atol=1e-8)
    np.testing.assert_allclose(nd[0]["pose_graph"][name]["rotations"],
                               single[name].rotations.numpy(), atol=1e-8)


def test_nd_pose_graph_cg_matches_dense(world):
    _, port, _, _ = world
    nd = _nd(port)
    cg = _replicated(nd, lambda r: r["pose_graph"]["cg32"]["translations"])
    dense = nd[0]["pose_graph"]["dense32"]
    np.testing.assert_allclose(cg, dense["translations"], atol=1e-6)
    np.testing.assert_allclose(nd[0]["pose_graph"]["cg32"]["costs"],
                               dense["costs"], rtol=1e-6, atol=1e-10)


def test_nd_distributed_normals_match_exact(world):
    """The two ``points`` shards hold every point once; the ``hosts`` rows
    hold the same shards bit for bit."""
    inp, port, single, _ = world
    nd = _nd(port)
    for r in (2, 3):
        for k in ("pos", "normals"):
            np.testing.assert_array_equal(nd[r]["normals"][k],
                                          nd[r - 2]["normals"][k])
    _check_normals([r["normals"] for r in nd[:2]], inp, single)


def test_nd_pipeline_with_mesh_matches_pipeline(world):
    _, port, single, _ = world
    traj = _replicated(_nd(port), lambda r: r["pipeline"])
    assert traj.shape == single["pipeline"].shape == (3, 3)
    np.testing.assert_allclose(traj, single["pipeline"], atol=2e-2)


def test_rehearsal_of_the_2d_mesh_gates(world):
    """``chip_smoke.py``'s 2-D mesh step of world (b) at small sizes: every
    gate passes (the ``hosts`` rows equal), its line is JSON; a rank whose
    results differ from its ``hosts`` twin is refused."""
    _, port, _, (cfg, refs) = world
    ranks_out = [r["rehearsal"] for r in port]
    g = chip_smoke.gate_mesh2d(ranks_out, refs, cfg)
    assert g["quantized_max_err"] == 0.0
    assert g["normals_within_6deg"] >= 0.99
    assert g["pose_cg_vs_single_dense"] <= 1e-6
    assert g["pose_cg_hosts_max_diff_m"] == 0.0      # no atomics on the CPU
    line = chip_smoke.mesh2d_line(ranks_out, cfg, g, "cpu")
    assert set(line["seconds"]) == {
        "sharded_bounds", "sharded_voxel_downsample",
        "sharded_voxel_downsample_merged", "morton_partition_halo",
        "distributed_normals", "distributed_icp_partitioned",
        "pose_graph_cg"}
    assert line["staged_bytes"]["sharded_bounds"] == 0
    json.dumps(line)
    bad = [dict(r) for r in ranks_out]
    bad[3] = dict(bad[3], mesh2d=dict(bad[3]["mesh2d"], digest=dict(
        bad[3]["mesh2d"]["digest"], normals="0")))
    with pytest.raises(AssertionError, match="hosts twin"):
        chip_smoke.gate_mesh2d(bad, refs, cfg)
