"""Rank bodies of the port's distributed tests (not a test module).

``tests/test_torch_parallel.py`` and ``tests/test_torch_distributed.py``
each start one world of four gloo ranks on the CPU
(``pasture_tpu_torch.parallel.spawn.run_world``) running one function of
this module, which drives every case of its file and returns numpy.  It
imports only the port (no JAX), so a rank starts quickly; the test
modules hold what comes back against the JAX package and the port's
single-device functions.
"""

from __future__ import annotations

import numpy as np
import torch

from pasture_tpu_torch.buffers.device import PointBatch
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.dtypes import DevicePolicy
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.parallel import (
    collective_counts, distributed_icp, distributed_icp_partitioned,
    distributed_normals, distributed_pose_graph, global_mesh, halo_exchange,
    make_mesh, morton_partition, reset_collective_counts, shard_batch,
    sharded_bounds, sharded_read_all, sharded_voxel_downsample,
    sharded_voxel_downsample_merged)
from pasture_tpu_torch import interop

POS = att.POSITION_3D.name
_BUILTIN = {a.name: a for a in att.BUILTIN_ATTRIBUTES}


def host_batch(cols: dict, count: int) -> PointBatch:
    """A CPU batch of numpy columns in their device dtypes (a u16 column
    as uint16, f64 positions under the exact policy)."""
    schema = PointSchema.from_attributes([_BUILTIN[n] for n in cols])
    policy = DevicePolicy.EXACT if cols[POS].dtype == np.float64 \
        else DevicePolicy.NARROW
    return interop.batch_from_reference_arrays(cols, count, list(cols),
                                               device="cpu", policy=policy)


def numpy_tree(x):
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(numpy_tree(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _partition(batch, mesh, **kw):
    out = morton_partition(batch, mesh, **kw)
    res = {"data": numpy_tree(out[0].data), "count": int(out[0].count),
           "counts": out[1].numpy(), "dropped": out[2].numpy()}
    if kw.get("return_spec"):
        res["spec"] = interop.spec_to_reference(out[3])
    return res, out


def parallel_cases(rank: int, size: int, inp: dict) -> dict:
    """Every case of tests/test_torch_parallel.py on this rank."""
    res = {"world": size}
    mesh = global_mesh(device="cpu")
    sub = {k: make_mesh(k, device="cpu") for k in (1, 2, 4)}
    res["meshes"] = {k: None if m is None else (m.rank, m.size, m.backend,
                                                dict(m.shape))
                     for k, m in sub.items()}
    m2d = global_mesh(("hosts", "points"), (2, 2), device="cpu")
    res["two_axes"] = (m2d.rank, m2d.size, m2d.backend, dict(m2d.shape),
                       m2d.coords, {a: (m2d.along(a).rank, m2d.along(a).size)
                                    for a in m2d.axis_names})
    m4 = sub[4]

    a = shard_batch(host_batch(inp["a"], inp["a_count"]), m4)
    res["shard_a"] = {"data": numpy_tree(a.data), "count": int(a.count)}
    mn, mx = sharded_bounds(a, m4)
    res["bounds"] = (mn.numpy(), mx.numpy())

    res["plain"], _ = _partition(a, m4, capacity_factor=4.0)
    res["sorted"], (part, counts, _, spec) = _partition(
        a, m4, capacity_factor=4.0, return_spec=True, sort_local=True)
    b = shard_batch(host_batch(inp["b"], inp["b_count"]), m4)
    res["spec"], _ = _partition(b, m4, capacity_factor=4.0, spec=spec)
    ordered = shard_batch(host_batch(inp["ordered"], inp["a_count"]), m4)
    res["overflow"], _ = _partition(ordered, m4, capacity_factor=1.0)
    hcols, hcounts = halo_exchange(part, counts, m4, inp["halo"])
    res["halo"] = (numpy_tree(hcols), hcounts.numpy())

    v = shard_batch(host_batch(inp["vox"], inp["vox_count"]), m4)
    vox, vcounts, aux = sharded_voxel_downsample(
        v, m4, inp["leaf"], with_aux=True, mode_runs=True)
    res["voxels"] = {"data": numpy_tree(vox.data), "count": int(vox.count),
                     "counts": vcounts.numpy(), "aux": numpy_tree(aux)}

    res["merged"] = {}
    full = host_batch(inp["merge"], inp["merge_count"])
    for k in (1, 2, 4):
        if sub[k] is None:
            continue
        merged, maux = sharded_voxel_downsample_merged(
            shard_batch(full, sub[k]), sub[k], inp["leaf"], mode_runs=True)
        res["merged"][k] = {"data": numpy_tree(merged.data),
                            "count": int(merged.count),
                            "counts": maux["counts"].numpy()}
        if k < 4:
            p, c, d = morton_partition(shard_batch(full, sub[k]), sub[k],
                                       capacity_factor=k, sort_local=True)
            hc, hn = halo_exchange(p, c, sub[k], inp["halo"])
            res[f"part{k}"] = {"data": numpy_tree(p.data), "counts":
                               c.numpy(), "dropped": d.numpy(),
                               "halo": (numpy_tree(hc), hn.numpy())}

    read = sharded_read_all(inp["files"], m4)
    res["read"] = {"data": numpy_tree(read.data), "count": int(read.count),
                   "device": str(read.device)}
    res["collectives"] = collective_counts()
    res["nd"] = nd_cases(inp, full)
    return res


def nd_cases(inp: dict, full: PointBatch) -> dict:
    """The cases of tests/test_torch_parallel.py on meshes of several axes:
    a ("hosts", "points") mesh of shape (2, 2) over each of its axes, and a
    three-axis (1, 2, 2) mesh over ``"points"``."""
    res = {}
    try:
        make_mesh(4, ("hosts", "points"), device="cpu")
    except ValueError as e:
        res["no_shape"] = str(e)
    m2 = make_mesh(4, ("hosts", "points"), (2, 2), device="cpu")
    m3 = make_mesh(4, ("slices", "hosts", "points"), (1, 2, 2), device="cpu")
    # a 2-D mesh of the first two ranks: the other two make its groups too
    # (or the world hangs) and get None
    part = make_mesh(2, ("hosts", "points"), (1, 2), device="cpu")
    res["first_two"] = None if part is None else (
        part.coords, int(sharded_bounds(
            shard_batch(full, part, "points"), part, "points")[0][0] >= 0))
    res["three_axes"] = (dict(m3.shape), m3.coords,
                         {a: (m3.along(a).rank, m3.along(a).size)
                          for a in m3.axis_names})
    reset_collective_counts()
    sharded_bounds(shard_batch(full, m2, "hosts"), m2, "hosts")
    res["bounds_collectives"] = collective_counts()
    for name, mesh, axis in (("points", m2, "points"), ("hosts", m2, "hosts"),
                             ("three_axes_points", m3, "points")):
        r = {}
        a = shard_batch(host_batch(inp["a"], inp["a_count"]), mesh, axis)
        r["shard_a"] = {"data": numpy_tree(a.data), "count": int(a.count)}
        r["bounds"] = tuple(x.numpy() for x in sharded_bounds(a, mesh, axis))
        r["sorted"], (part, counts, _, spec) = _partition(
            a, mesh, axis=axis, capacity_factor=4.0, return_spec=True,
            sort_local=True)
        b = shard_batch(host_batch(inp["b"], inp["b_count"]), mesh, axis)
        r["spec"], _ = _partition(b, mesh, axis=axis, capacity_factor=4.0,
                                  spec=spec)
        hcols, hcounts = halo_exchange(part, counts, mesh, inp["halo"], axis)
        r["halo"] = (numpy_tree(hcols), hcounts.numpy())
        v = shard_batch(host_batch(inp["vox"], inp["vox_count"]), mesh, axis)
        vox, vcounts, aux = sharded_voxel_downsample(
            v, mesh, inp["leaf"], axis, with_aux=True, mode_runs=True)
        r["voxels"] = {"data": numpy_tree(vox.data), "count": int(vox.count),
                       "counts": vcounts.numpy(), "aux": numpy_tree(aux)}
        merged, maux = sharded_voxel_downsample_merged(
            shard_batch(full, mesh, axis), mesh, inp["leaf"], axis,
            mode_runs=True)
        r["merged"] = {"data": numpy_tree(merged.data),
                       "count": int(merged.count),
                       "counts": maux["counts"].numpy()}
        read = sharded_read_all(inp["files"], mesh, axis=axis)
        r["read"] = {"data": numpy_tree(read.data), "count": int(read.count)}
        res[name] = r
    return res


def distributed_nd_cases(rank: int, inp: dict, pose) -> dict:
    """The registration cases of tests/test_torch_distributed.py over
    ``"points"`` of a ("hosts", "points") mesh of shape (2, 2)."""
    mesh = make_mesh(4, ("hosts", "points"), (2, 2), device="cpu")
    line = mesh.along("points")
    res = {}
    src = torch.from_numpy(inp["icp_source"])
    per = src.shape[0] // line.size
    res["icp"] = pose(distributed_icp(
        src[line.rank * per:(line.rank + 1) * per],
        torch.from_numpy(inp["icp_target"]), mesh, axis="points",
        max_correspondence_distance=2.0, iterations=10))
    for name, kw in inp["partitioned"].items():
        s, t = (shard_batch(host_batch({POS: inp[f"{name}_{k}"]},
                                       len(inp[f"{name}_{k}"])), mesh)
                for k in ("source", "target"))
        r, dropped = distributed_icp_partitioned(
            s, t, mesh, "points", capacity_factor=4.0,
            max_correspondence_distance=2.0, iterations=10, **kw)
        res[name] = {**pose(r), "dropped": int(dropped)}
    graphs = {}
    for name, (arrays, kw) in inp["pose_graphs"].items():
        g = interop.pose_graph_from_reference(*arrays, device="cpu")
        opt, costs = distributed_pose_graph(g, mesh, "points", **kw)
        graphs[name] = {"translations": opt.translations.numpy(),
                        "rotations": opt.rotations.numpy(),
                        "costs": costs.numpy()}
    res["pose_graph"] = graphs
    part, nrm, _, counts, dropped = distributed_normals(
        shard_batch(host_batch({POS: inp["normals"]}, len(inp["normals"])),
                    mesh), mesh, 12, window=48, axis="points",
        capacity_factor=4.0)
    c = int(counts[line.rank])
    res["normals"] = {"pos": part.data[POS][:c].numpy(),
                      "normals": nrm[:c].numpy(),
                      "dropped": dropped.numpy()}
    from pasture_tpu_torch.pipeline import RegistrationPipeline
    pipe = RegistrationPipeline(mesh=mesh, **inp["pipeline"])
    for scan in inp["scans"]:
        pipe.add_scan(scan)
    res["pipeline"] = pipe.trajectory()
    return res


def distributed_cases(rank: int, size: int, inp: dict) -> dict:
    """Every case of tests/test_torch_distributed.py on this rank."""
    mesh = make_mesh(size, device="cpu")
    res = {}

    def pose(r):
        return {"rotation": r.rotation.numpy(),
                "translation": r.translation.numpy(),
                "num_inliers": int(r.num_inliers), "rmse": float(r.rmse)}

    src = torch.from_numpy(inp["icp_source"])
    per = src.shape[0] // size
    res["icp"] = pose(distributed_icp(
        src[rank * per:(rank + 1) * per], torch.from_numpy(inp["icp_target"]),
        mesh, max_correspondence_distance=2.0, iterations=10))

    for name, kw in inp["partitioned"].items():
        s, t = (shard_batch(host_batch({POS: inp[f"{name}_{k}"]},
                                       len(inp[f"{name}_{k}"])), mesh)
                for k in ("source", "target"))
        r, dropped = distributed_icp_partitioned(
            s, t, mesh, capacity_factor=4.0, max_correspondence_distance=2.0,
            iterations=10, **kw)
        res[name] = {**pose(r), "dropped": int(dropped)}

    graphs = {}
    for name, (arrays, kw) in inp["pose_graphs"].items():
        g = interop.pose_graph_from_reference(*arrays, device="cpu")
        opt, costs = distributed_pose_graph(g, mesh, **kw)
        graphs[name] = {"translations": opt.translations.numpy(),
                        "rotations": opt.rotations.numpy(),
                        "costs": costs.numpy()}
    res["pose_graph"] = graphs

    part, nrm, curv, counts, dropped = distributed_normals(
        shard_batch(host_batch({POS: inp["normals"]}, len(inp["normals"])),
                    mesh), mesh, 12, window=48, capacity_factor=4.0)
    c = int(counts[rank])
    res["normals"] = {"pos": part.data[POS][:c].numpy(),
                      "normals": nrm[:c].numpy(),
                      "curvature": curv[:c].numpy(),
                      "dropped": dropped.numpy()}

    from pasture_tpu_torch.pipeline import RegistrationPipeline
    pipe = RegistrationPipeline(mesh=mesh, **inp["pipeline"])
    for scan in inp["scans"]:
        pipe.add_scan(scan)
    res["pipeline"] = pipe.trajectory()
    tight = RegistrationPipeline(mesh=mesh, distributed_capacity_factor=0.5,
                                 **inp["pipeline"])
    for scan in inp["scans"][:2]:
        try:
            tight.add_scan(scan)
        except RuntimeError as e:
            res["tight"] = str(e)

    res["nd"] = distributed_nd_cases(rank, inp, pose)
    # the cases' counts (the rehearsal's steps reset them)
    res["collectives"] = collective_counts()

    if inp.get("rehearsal") is not None:
        import pathlib
        import time

        import chip_smoke
        work, cfg = inp["rehearsal"]
        ready = pathlib.Path(work) / "ready"
        deadline = time.monotonic() + 120
        while not ready.exists():      # the test writes the inputs meanwhile
            if time.monotonic() > deadline:
                raise TimeoutError("the rehearsal's inputs never came")
            time.sleep(0.05)
        res["rehearsal"] = chip_smoke.distributed_world(rank, size, work,
                                                        cfg)
    return res
