"""The port's distributed layer against the JAX package on the CPU:
meshes, sharding, Morton partition, halo exchange, sharded bounds and the
sharded voxelize, and the merged voxelize against the port's one-shot
``voxel_downsample``.

One world of four gloo ranks on the CPU (a module fixture, started through
``initialize_multihost`` with an explicit coordinator) runs every case of
this file (``torch_parallel_ranks.parallel_cases``) and returns numpy;
``make_mesh(1)``, ``make_mesh(2)`` and ``make_mesh(4)`` all come from that
world.  While it runs, this process runs the JAX package on ``make_mesh(4)``
of the conftest's eight virtual devices, each function under one
``jax.jit``.  Partition, halo exchange and bounds must equal the JAX
package's per-shard results bit for bit; the sharded voxelize's partials
and merge statistics meet ``test_torch_voxel_merge.py``'s tolerances
(centroids 1e-5, integer means within 1, statistics and run tables
exact); the merged voxelize equals the port's single-device result as
``tests/test_parallel.py`` holds the reference's (centroids rtol 1e-9,
integer means within 1, mode exact with run tables).

The same world also lays its four ranks out as a ``("hosts", "points")``
mesh of shape (2, 2) and as a three-axis (1, 2, 2) mesh; over each axis of
the 2-D mesh the port's shard, partition (and spec), halo, bounds and
shard voxel partials must equal the JAX package's on ``make_mesh(4,
axes=("hosts", "points"), shape=(2, 2))`` (each axis under one
``jax.jit``) bit for bit, every rank holding the block of its coordinate
on the axis (of the partials, all but the centroids, which keep the 1e-5
of the 1-D case); the three-axis mesh over ``"points"`` must give the 2-D
mesh's results.  The merged voxelize on each equals the single device as
on the 1-D meshes."""

import importlib.util
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pasture_tpu.buffers.device as jdev
from pasture_tpu.layout import attributes as jatt
from pasture_tpu.layout.schema import PointSchema as JPointSchema
from pasture_tpu.math.morton import morton_encode_u64
from pasture_tpu.parallel import (halo_exchange as j_halo,
                                  make_mesh as j_make_mesh,
                                  morton_partition as j_partition,
                                  shard_batch as j_shard,
                                  sharded_bounds as j_bounds,
                                  sharded_voxel_downsample as j_voxel)

import torch_parallel_ranks as ranks
from pasture_tpu_torch import interop
from pasture_tpu_torch.buffers.host import HostPointBuffer
from pasture_tpu_torch.io import read_all, write_all
from pasture_tpu_torch.layout import attributes as att
from pasture_tpu_torch.layout.schema import PointSchema
from pasture_tpu_torch.ops import voxel_downsample
from pasture_tpu_torch.parallel.spawn import run_world

POS, INT, CLS = "Position3D", "Intensity", "Classification"
SIZE = 4
# the world's ranks stop before the test's own time limit (conftest.py's
# default), so a stuck rank fails with the ranks named
WORLD_TIMEOUT_S = 150.0
ND_SHAPE = {"hosts": 2, "points": 2}
# (the ranks' case, the JAX case it must equal, the axis)
ND_CASES = (("points", "points"), ("hosts", "hosts"),
            ("three_axes_points", "points"))
N, CAP = 1000, 1024
HALO = 16
LEAF = 1.0
BENCH = Path(__file__).resolve().parents[1] / "benchmark"
# a 2 x 2 block of 40 m x 50 m sub-tiles at 2 points a square metre: the
# sheet fold's shape at a size the CPU holds, one sub-tile a rank
SHEET = ((136000, 455000), (136040, 455000), (136000, 455050),
         (136040, 455050))
# files of unequal sizes (a rank's rows straddle three of them), more
# ranks than files (one rank's rows straddle both, one holds none), and
# .pnts files, whose reader cannot seek (a rank decodes each file it needs
# whole)
SIZES = {"uneven": (700, 130, 455), "few": (3, 2), "pnts": (5, 3)}


def _pad(cols, cap=CAP):
    return {k: np.pad(v, [(0, cap - len(v))] + [(0, 0)] * (v.ndim - 1))
            for k, v in cols.items()}


def _inputs(workdir) -> dict:
    rng = np.random.default_rng(42)
    a = {POS: rng.uniform(0, 10, (N, 3)),
         INT: rng.integers(0, 100, N).astype(np.uint16)}
    b = {POS: rng.uniform(2, 9, (700, 3)),
         INT: rng.integers(0, 100, 700).astype(np.uint16)}
    order = np.argsort(a[POS][:, 0], kind="stable")
    vox = {POS: rng.uniform(0, 6, (N, 3)).astype(np.float32),
           INT: rng.integers(0, 65536, N).astype(np.uint16),
           CLS: rng.integers(0, 8, N).astype(np.uint8)}
    merge = {POS: rng.uniform(0, 6, (N, 3)),
             INT: rng.integers(0, 65536, N).astype(np.uint16),
             CLS: rng.integers(0, 8, N).astype(np.uint8)}
    schema = PointSchema.from_attributes([att.POSITION_3D, att.INTENSITY])
    files = []
    for i in range(4):
        path = workdir / f"part{i}.las"
        write_all(HostPointBuffer.from_columns(schema, {
            POS: np.round(rng.uniform(0, 50, (250, 3)), 3),
            INT: rng.integers(0, 4096, 250).astype(np.uint16)}), path)
        files.append(str(path))
    sized = {}
    for name, sizes in SIZES.items():
        sized[name] = []
        for i, n in enumerate(sizes):
            ext = "pnts" if name == "pnts" else "las"
            path = workdir / f"{name}{i}.{ext}"
            write_all(HostPointBuffer.from_columns(schema, {
                POS: np.round(rng.uniform(0, 50, (n, 3)), 3),
                INT: rng.integers(0, 4096, n).astype(np.uint16)}), path)
            sized[name].append(str(path))
    sheet, block = _sheet(workdir)
    return {"a": _pad(a), "a_count": N, "b": _pad(b), "b_count": 700,
            "ordered": _pad({k: v[order] for k, v in a.items()}),
            "vox": _pad(vox), "vox_count": N, "merge": _pad(merge),
            "merge_count": N, "halo": HALO, "leaf": LEAF, "files": files,
            **sized, "sheet": sheet, "sheet_block": block}


def _bench(rel: str):
    """A module of the benchmark's folder by its path (``reference/
    voxel_map``): the plain reference, the scene and the LAS writer import
    nothing of the program."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + rel.replace("/", "_"), BENCH / f"{rel}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sheet(workdir):
    """The block's sub-tiles made by the benchmark's scene generator and
    written by its LAS writer, each with its south-west corner as its LAS
    offset; returns their paths and the block's ``(local, intensity,
    classification)`` in the frame of the first corner, as numpy."""
    cfg = json.loads((BENCH / "configs" / "ahn4-block-2x2.json")
                     .read_text())
    cfg.update(size_m=[40, 50], points_per_m2=2)
    ahn4, lasfile = _bench("scenes/ahn4"), _bench("lasfile")
    paths, parts = [], []
    for i, (x, y) in enumerate(SHEET):
        t = ahn4.make_tile(dict(cfg, offset=[float(x), float(y), 0.0]),
                           1000 + i, "cpu")
        path = workdir / f"sub{i}.las"
        lasfile.write_las(path, t["local"].numpy(), t["intensity"].numpy(),
                          t["classification"].numpy(), scale=cfg["scale"],
                          offset=[float(x), float(y), 0.0])
        paths.append(str(path))
        shift = np.asarray([(x - SHEET[0][0]) * 1000,
                            (y - SHEET[0][1]) * 1000, 0], np.int32)
        parts.append((t["local"].numpy() + shift, t["intensity"].numpy(),
                      t["classification"].numpy()))
    return paths, tuple(np.concatenate(c) for c in zip(*parts))


def _jbatch(cols, count, mesh, axis="points"):
    schema = JPointSchema.from_attributes(
        [x for n in cols for x in jatt.BUILTIN_ATTRIBUTES if x.name == n])
    batch = jdev.PointBatch({k: jnp.asarray(v) for k, v in cols.items()},
                            jnp.asarray(count, jnp.int32), schema, {})
    return j_shard(batch, mesh, axis)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_side(inp) -> dict:
    mesh = j_make_mesh(SIZE)
    a = _jbatch(inp["a"], N, mesh)
    out = {"bounds": _np(jax.jit(lambda b: j_bounds(b, mesh))(a))}
    part = jax.jit(lambda b: j_partition(b, mesh, capacity_factor=4.0))
    out["plain"] = _np(part(a))
    p, c, d, spec = jax.jit(lambda b: j_partition(
        b, mesh, capacity_factor=4.0, return_spec=True,
        sort_local=True))(a)
    out["sorted"] = _np((p, c, d))
    out["spec_of_sorted"] = _np(tuple(spec))
    out["spec"] = _np(jax.jit(lambda b, s: j_partition(
        b, mesh, capacity_factor=4.0, spec=s))(
        _jbatch(inp["b"], 700, mesh), spec))
    out["overflow"] = _np(jax.jit(lambda b: j_partition(
        b, mesh, capacity_factor=1.0))(_jbatch(inp["ordered"], N, mesh)))
    out["halo"] = _np(jax.jit(lambda b, c: j_halo(b, c, mesh, HALO))(p, c))
    out["voxels"] = _np(jax.jit(lambda b: j_voxel(
        b, mesh, LEAF, with_aux=True, mode_runs=True))(
        _jbatch(inp["vox"], N, mesh)))
    return out


def _jax_nd(inp, axis) -> dict:
    """The JAX package over ``axis`` of the (2, 2) ("hosts", "points")
    mesh: shard, bounds, sorted partition and its spec, the co-partition,
    halo and the shard voxel partials, under one ``jax.jit``."""
    mesh = j_make_mesh(SIZE, axes=("hosts", "points"), shape=(2, 2))
    a, b, v = (_jbatch(inp[k], c, mesh, axis)
               for k, c in (("a", N), ("b", 700), ("vox", N)))

    def run(a, b, v):
        bounds = j_bounds(a, mesh, axis)
        p, c, d, spec = j_partition(a, mesh, axis, capacity_factor=4.0,
                                    return_spec=True, sort_local=True)
        co = j_partition(b, mesh, axis, capacity_factor=4.0, spec=spec)
        halo = j_halo(p, c, mesh, HALO, axis)
        vox = j_voxel(v, mesh, LEAF, axis, with_aux=True, mode_runs=True)
        return bounds, (p, c, d), tuple(spec), co, halo, vox
    out = dict(zip(("bounds", "sorted", "spec_of_sorted", "spec", "halo",
                    "voxels"), _np(jax.jit(run)(a, b, v))))
    out["shard_a"] = _np(a.data)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``(inputs, each rank's results, the JAX package's results)``."""
    inp = _inputs(tmp_path_factory.mktemp("parallel"))
    with ThreadPoolExecutor(max_workers=3) as ex:
        port = ex.submit(run_world, ranks.parallel_cases, SIZE, (inp,),
                         "cpu", None, WORLD_TIMEOUT_S)
        # XLA compiles with the interpreter lock released: the 2-D mesh's
        # two programs compile beside the 1-D ones
        nd = {axis: ex.submit(_jax_nd, inp, axis)
              for axis in ("points", "hosts")}
        ref = _jax_side(inp)
        ref["nd"] = {axis: f.result() for axis, f in nd.items()}
        return inp, port.result(), ref


def _shards(x):
    return interop.shards_from_reference(x, SIZE)


def test_world_meshes_and_shards(world):
    inp, port, _ = world
    for r, res in enumerate(port):
        assert res["world"] == SIZE
        for k, m in res["meshes"].items():
            assert m == ((r, k, "gloo", {"points": k}) if r < k else None)
        # the 2-D mesh of global_mesh: row-major coordinates, one line a
        # rank along each axis
        h, p = divmod(r, 2)
        assert res["two_axes"] == (r, SIZE, "gloo", ND_SHAPE, (h, p),
                                   {"hosts": (h, 2), "points": (p, 2)})
        per = CAP // SIZE
        assert res["shard_a"]["count"] == min(max(N - r * per, 0), per)
        for name, col in inp["a"].items():
            np.testing.assert_array_equal(
                res["shard_a"]["data"][name], col[r * per:(r + 1) * per])


@pytest.mark.parametrize("case", ("plain", "sorted", "spec", "overflow"))
def test_morton_partition_matches_jax_bit_for_bit(world, case):
    _, port, ref = world
    jbatch, jcounts, jdropped = ref[case]
    if case == "overflow":
        assert int(jdropped.sum()) > 0       # the case must overflow
    for r, res in enumerate(port):
        got = res[case]
        np.testing.assert_array_equal(got["counts"], jcounts)
        np.testing.assert_array_equal(got["dropped"], jdropped)
        assert got["count"] == int(jbatch.count)
        for name, col in jbatch.data.items():
            np.testing.assert_array_equal(
                got["data"][name], _shards(col)[r].astype(
                    got["data"][name].dtype), err_msg=f"{case} {name} {r}")


def test_partition_spec_matches_jax(world):
    _, port, ref = world
    for res in port:
        for got, want in zip(res["sorted"]["spec"], ref["spec_of_sorted"]):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


def test_halo_exchange_matches_jax(world):
    _, port, ref = world
    jcols, jcounts = ref["halo"]
    for r, res in enumerate(port):
        cols, counts = res["halo"]
        np.testing.assert_array_equal(counts, jcounts[r])
        for name, col in jcols.items():
            np.testing.assert_array_equal(
                cols[name], _shards(col)[r].astype(cols[name].dtype))


def test_sharded_bounds_match_jax(world):
    _, port, ref = world
    for res in port:
        for got, want in zip(res["bounds"], ref["bounds"]):
            np.testing.assert_array_equal(got, want)


def test_sharded_voxel_partials_match_jax(world):
    """Per-shard voxels and merge statistics, run tables included."""
    _, port, ref = world
    _check_voxel_partials([res["voxels"] for res in port], ref["voxels"],
                          SIZE, None)


def _check_voxel_partials(ranks_got, ref, size, axis, exact=False):
    """Each rank's voxels and merge statistics against its block of the
    JAX package's (``size`` and ``axis`` as ``interop
    .shards_from_reference`` takes them); ``exact``: the integer means and
    raw means too bit for bit.  Centroids stay within 1e-5: the port sums
    an f32 mean in f64 (``test_torch_voxel_merge.py``), one ulp off
    JAX's f32 sum on some voxels."""
    jbatch, jcounts, jaux = ref
    jauxes = interop.aux_shards_from_reference(jaux, size, axis)
    coord = interop.shards_from_reference(np.arange(len(jcounts)), size,
                                          axis)
    for r, got in enumerate(ranks_got):
        np.testing.assert_array_equal(got["counts"], jcounts)
        assert got["count"] == int(jbatch.count) == int(jcounts.sum())
        nv = int(jcounts[int(coord[r][0])])
        want = {k: interop.shards_from_reference(v, size, axis)[r]
                for k, v in jbatch.data.items()}
        np.testing.assert_allclose(got["data"][POS][:nv], want[POS][:nv],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["data"][CLS][:nv],
                                      want[CLS][:nv])
        if exact:
            np.testing.assert_array_equal(
                got["data"][INT][:nv],
                want[INT][:nv].astype(got["data"][INT].dtype))
        di = got["data"][INT][:nv].astype(np.int64) - want[INT][:nv]
        assert np.abs(di).max() <= 1
        aux = interop.aux_to_reference(interop.aux_from_reference(
            got["aux"], device="cpu"))
        want_aux = jauxes[r]
        for i, k in enumerate(want_aux["keys"]):
            np.testing.assert_array_equal(aux["keys"][i], k)
        np.testing.assert_array_equal(aux["counts"], want_aux["counts"])
        for d in ("mode_counts", "mode2_values", "mode2_counts"):
            for n, v in want_aux[d].items():
                np.testing.assert_array_equal(aux[d][n], v, err_msg=d)
        for n, v in want_aux["raw_means"].items():
            np.testing.assert_allclose(aux["raw_means"][n][:nv], v[:nv],
                                       rtol=1e-6)
            if exact:
                np.testing.assert_array_equal(aux["raw_means"][n][:nv],
                                              v[:nv])
        rt, want_rt = aux["mode_runs"][CLS], want_aux["mode_runs"][CLS]
        for k in ("values", "counts", "num_runs"):
            np.testing.assert_array_equal(rt[k], want_rt[k], err_msg=k)
        np.testing.assert_array_equal(rt["keys"][0], want_rt["keys"][0])


@pytest.mark.parametrize("k", (1, 2, 4))
def test_merged_voxelize_equals_single_device(world, k):
    inp, port, _ = world
    full = ranks.host_batch(inp["merge"], N)
    single = voxel_downsample(full, LEAF, semantics="floor",
                              bounds=(full.data[POS][:N].amin(0), None))
    nv = int(single.count)
    want = {n: v[:nv].numpy() for n, v in single.data.items()}
    for res in port[:k]:
        got = res["merged"][k]
        assert got["count"] == nv
        assert int(got["counts"].sum()) == N
        np.testing.assert_allclose(got["data"][POS][:nv], want[POS],
                                   rtol=1e-9, atol=1e-9)
        assert np.abs(got["data"][INT][:nv].astype(np.int64)
                      - want[INT]).max() <= 1
        np.testing.assert_array_equal(got["data"][CLS][:nv], want[CLS])
    # replicated: every rank of the mesh holds the same bytes
    for res in port[1:k]:
        for n in want:
            np.testing.assert_array_equal(res["merged"][k]["data"][n],
                                          port[0]["merged"][k]["data"][n])


def _keys(pos, gmin, iso):
    cell = np.clip((pos - gmin) / iso * (1 << 20), 0,
                   (1 << 20) - 1).astype(np.uint64)
    return morton_encode_u64(cell[:, 0], cell[:, 1], cell[:, 2])


@pytest.mark.parametrize("k", (1, 2, 4))
def test_partition_relations(world, k):
    """The relations of tests/test_parallel.py and tests/test_halo.py on
    meshes of 1, 2 and 4 ranks: nothing dropped, every point once, shards
    on ascending Morton ranges and sorted, halo rows the neighbours'
    tail and head."""
    inp, port, _ = world
    src = inp["merge"][POS][:N]
    gmin, gmax = src.min(0), src.max(0)
    iso = max((gmax - gmin).max(), 1e-9)
    parts = [res[f"part{k}"] if k < 4 else None for res in port[:k]]
    if k == 4:   # the sorted partition of cloud a, halo of HALO rows
        src = inp["a"][POS][:N]
        gmin, gmax = src.min(0), src.max(0)
        iso = max((gmax - gmin).max(), 1e-9)
        parts = [{"data": res["sorted"]["data"],
                  "counts": res["sorted"]["counts"],
                  "dropped": res["sorted"]["dropped"],
                  "halo": res["halo"]} for res in port]
    counts = parts[0]["counts"]
    assert counts.sum() == N and parts[0]["dropped"].sum() == 0
    shards = [p["data"][POS][:counts[r]] for r, p in enumerate(parts)]
    np.testing.assert_array_equal(
        np.sort(np.concatenate(shards), axis=0), np.sort(src, axis=0))
    keys = [_keys(s, gmin, iso) for s in shards]
    for kk in keys:
        assert np.all(kk[1:] >= kk[:-1])
    shift = np.uint64(60 - 12)
    ranges = [(kk.min(), kk.max()) for kk in keys if len(kk)]
    for lo, hi in zip(ranges[:-1], ranges[1:]):
        assert (lo[1] >> shift) <= (hi[0] >> shift) + np.uint64(1)
    for r, p in enumerate(parts):
        cols, hc = p["halo"]
        left, right = (r - 1) % k, (r + 1) % k
        ln, rn = min(counts[left], HALO), min(counts[right], HALO)
        assert tuple(hc) == (ln, rn)
        np.testing.assert_array_equal(cols[POS][:ln],
                                      shards[left][counts[left] - ln:])
        np.testing.assert_array_equal(cols[POS][HALO:HALO + rn],
                                      shards[right][:rn])


def test_sharded_read_all(world):
    inp, port, _ = world
    host = HostPointBuffer.concat([read_all(p) for p in inp["files"]])
    per = len(host) // SIZE
    for r, res in enumerate(port):
        got = res["read"]
        assert got["device"] == "cpu" and got["count"] == per
        for name in host.schema.names:
            want = host.columns[name][r * per:(r + 1) * per]
            np.testing.assert_array_equal(
                got["data"][name], want.astype(got["data"][name].dtype))


def test_collectives_counted_and_not_staged(world):
    _, port, _ = world
    for res in port:
        c = res["collectives"]
        for name in ("all_reduce", "all_gather", "all_to_all", "ring"):
            assert c[name]["calls"] > 0 and c[name]["bytes"] > 0, name
        assert c["staged"] == {"to_host_bytes": 0, "to_device_bytes": 0}


def test_interop_carries_shards_and_specs(world):
    _, port, ref = world
    col = ref["sorted"][0].data[POS]
    np.testing.assert_array_equal(
        interop.shards_to_reference(_shards(col)), col)
    spec = interop.spec_from_reference(*ref["spec_of_sorted"], device="cpu")
    assert spec.dest_of_bucket.dtype == torch.int64
    for got, want in zip(interop.spec_to_reference(spec),
                         ref["spec_of_sorted"]):
        np.testing.assert_array_equal(got, want)


def _nd(world, case):
    """``(each rank's results, the JAX package's, the axis, shards of a
    JAX global array for each rank)`` of an N-D mesh case."""
    _, port, ref = world
    axis = dict((c, a) for c, a in ND_CASES)[case]
    return ([res["nd"][case] for res in port], ref["nd"][axis], axis,
            lambda x: interop.shards_from_reference(x, ND_SHAPE, axis))


def test_nd_mesh_needs_shape_and_lays_out_three_axes(world):
    _, port, _ = world
    for r, res in enumerate(port):
        assert "shape required" in res["nd"]["no_shape"]
        # the ranks outside a mesh of the first two get None, and its
        # ranks run a collective on it
        assert res["nd"]["first_two"] == (((0, r), 1) if r < 2 else None)
        h, p = divmod(r, 2)
        assert res["nd"]["three_axes"] == (
            {"slices": 1, "hosts": 2, "points": 2}, (0, h, p),
            {"slices": (0, 1), "hosts": (h, 2), "points": (p, 2)})


def test_nd_collectives_counted_once(world):
    """One sharded_bounds over an axis of the 2-D mesh is one all-reduce
    of six values on each rank, and nothing else."""
    _, port, _ = world
    for res in port:
        c = res["nd"]["bounds_collectives"]
        assert c["all_reduce"] == {"calls": 1, "bytes": 6 * 8}
        assert all(c[k]["calls"] == 0 for k in
                   ("all_gather", "all_to_all", "ring"))


@pytest.mark.parametrize("case", [c for c, _ in ND_CASES])
def test_nd_shard_matches_jax(world, case):
    got, ref, axis, shards = _nd(world, case)
    per = CAP // ND_SHAPE[axis]
    for r, res in enumerate(got):
        coord = divmod(r, 2)[("hosts", "points").index(axis)]
        assert res["shard_a"]["count"] == min(max(N - coord * per, 0), per)
        for name, col in ref["shard_a"].items():
            np.testing.assert_array_equal(
                res["shard_a"]["data"][name],
                shards(col)[r].astype(res["shard_a"]["data"][name].dtype))


@pytest.mark.parametrize("case", [c for c, _ in ND_CASES])
@pytest.mark.parametrize("part", ("sorted", "spec"))
def test_nd_partition_matches_jax_bit_for_bit(world, case, part):
    got, ref, axis, shards = _nd(world, case)
    jbatch, jcounts, jdropped = ref[part]
    assert jcounts.shape == (2,)
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res[part]["counts"], jcounts)
        np.testing.assert_array_equal(res[part]["dropped"], jdropped)
        assert res[part]["count"] == int(jbatch.count)
        for name, col in jbatch.data.items():
            np.testing.assert_array_equal(
                res[part]["data"][name],
                shards(col)[r].astype(res[part]["data"][name].dtype),
                err_msg=f"{case} {part} {name} {r}")


@pytest.mark.parametrize("case", [c for c, _ in ND_CASES])
def test_nd_partition_spec_matches_jax(world, case):
    got, ref, _, _ = _nd(world, case)
    for res in got:
        for g, w in zip(res["sorted"]["spec"], ref["spec_of_sorted"]):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("case", [c for c, _ in ND_CASES])
def test_nd_halo_matches_jax(world, case):
    got, ref, _, shards = _nd(world, case)
    jcols, jcounts = ref["halo"]
    for r, res in enumerate(got):
        cols, counts = res["halo"]
        np.testing.assert_array_equal(counts, shards(jcounts)[r][0])
        for name, col in jcols.items():
            np.testing.assert_array_equal(
                cols[name], shards(col)[r].astype(cols[name].dtype))


@pytest.mark.parametrize("case", [c for c, _ in ND_CASES])
def test_nd_bounds_match_jax(world, case):
    got, ref, _, _ = _nd(world, case)
    for res in got:
        for g, w in zip(res["bounds"], ref["bounds"]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", [c for c, _ in ND_CASES])
def test_nd_voxel_partials_match_jax(world, case):
    got, ref, axis, _ = _nd(world, case)
    _check_voxel_partials([res["voxels"] for res in got], ref["voxels"],
                          ND_SHAPE, axis, exact=True)


@pytest.mark.parametrize("case", [c for c, _ in ND_CASES])
def test_nd_merged_voxelize_equals_single_device(world, case):
    inp, _, _ = world
    got, _, _, _ = _nd(world, case)
    full = ranks.host_batch(inp["merge"], N)
    single = voxel_downsample(full, LEAF, semantics="floor",
                              bounds=(full.data[POS][:N].amin(0), None))
    nv = int(single.count)
    for res in got:
        m = res["merged"]
        assert m["count"] == nv and int(m["counts"].sum()) == N
        np.testing.assert_allclose(m["data"][POS][:nv],
                                   single.data[POS][:nv].numpy(),
                                   rtol=1e-9, atol=1e-9)
        assert np.abs(m["data"][INT][:nv].astype(np.int64)
                      - single.data[INT][:nv].numpy()).max() <= 1
        np.testing.assert_array_equal(m["data"][CLS][:nv],
                                      single.data[CLS][:nv].numpy())
        for n in m["data"]:
            np.testing.assert_array_equal(m["data"][n],
                                          got[0]["merged"]["data"][n])


@pytest.mark.parametrize("case", [c for c, _ in ND_CASES])
def test_nd_sharded_read_all(world, case):
    inp, _, _ = world
    got, _, axis, _ = _nd(world, case)
    host = HostPointBuffer.concat([read_all(p) for p in inp["files"]])
    per = len(host) // ND_SHAPE[axis]
    for r, res in enumerate(got):
        c = divmod(r, 2)[("hosts", "points").index(axis)]
        assert res["read"]["count"] == per
        for name in host.schema.names:
            want = host.columns[name][c * per:(c + 1) * per]
            np.testing.assert_array_equal(
                res["read"]["data"][name],
                want.astype(res["read"]["data"][name].dtype))


@pytest.mark.parametrize("axis", ("points", "hosts"))
def test_nd_interop_carries_shards(world, axis):
    """A JAX array sharded over one axis of the (2, 2) mesh: every rank's
    block by its coordinate on the axis, and the line through rank 0 joins
    back to the array."""
    _, _, ref = world
    col = ref["nd"][axis]["sorted"][0].data[POS]
    blocks = interop.shards_from_reference(col, ND_SHAPE, axis)
    assert len(blocks) == SIZE
    for r, b in enumerate(blocks):
        c = divmod(r, 2)[("hosts", "points").index(axis)]
        np.testing.assert_array_equal(b, np.split(col, 2)[c])
    np.testing.assert_array_equal(
        interop.shards_to_reference(blocks, ND_SHAPE, axis), col)


def _rows(paths):
    """The concatenated files, each rank's ``[lo, hi)`` of it and the
    shard capacity: today's rows, as every rank read them before."""
    host = HostPointBuffer.concat([read_all(p) for p in paths])
    total = len(host)
    per = max(-(-total // SIZE), 1)
    return host, per, [(min(r * per, total), min(r * per + per, total))
                       for r in range(SIZE)]


@pytest.mark.parametrize("case", list(SIZES))
def test_rank_local_read_gives_the_same_rows(world, case):
    inp, port, _ = world
    host, per, spans = _rows(inp[case])
    edges = np.cumsum(SIZES[case])[:-1]
    # a rank's rows straddle a file's end; with more ranks than files one
    # rank holds no row
    assert any(lo < e < hi for lo, hi in spans for e in edges)
    assert case != "few" or any(lo == hi for lo, hi in spans)
    for r, res in enumerate(port):
        got = res["ingest"][case]
        lo, hi = spans[r]
        assert got["capacity"] == per and got["count"] == hi - lo
        for name in host.schema.names:
            col = got["data"][name]
            np.testing.assert_array_equal(
                col[:hi - lo], host.columns[name][lo:hi].astype(col.dtype))
            assert not col[hi - lo:].any()


@pytest.mark.parametrize("case", list(SIZES) + ["sheet"])
def test_rank_local_read_decodes_only_its_rows(world, case):
    inp, port, _ = world
    _, _, spans = _rows(inp[case])
    if case == "sheet":
        # one sub-tile a rank: a rank's rows are its own file's points
        assert spans == [(r * 4000, r * 4000 + 4000) for r in range(SIZE)]
    for r, res in enumerate(port):
        lo, hi = spans[r]
        want = hi - lo
        if case == "pnts":
            # every file that holds one of the rank's rows, whole
            ends = np.cumsum(SIZES[case])
            want = sum(n for n, e in zip(SIZES[case], ends)
                       if lo < e and hi > e - n)
        assert res["ingest"][case]["decoded"] == want


def test_capacity_multiple_pads_with_invalid_rows(world):
    inp, port, _ = world
    host, per, spans = _rows(inp["uneven"])
    assert per % 512
    for r, res in enumerate(port):
        got, plain = res["ingest"]["padded"], res["ingest"]["uneven"]
        lo, hi = spans[r]
        assert got["capacity"] == -(-per // 512) * 512
        assert got["count"] == plain["count"] == hi - lo
        for name, col in got["data"].items():
            np.testing.assert_array_equal(col[:per], plain["data"][name])
            assert not col[per:].any()


def test_sheet_fold_equals_plain_reference(world):
    """The sharded fold of the 2 x 2 block on four ranks against the plain
    reference's map of the whole block (``benchmark/reference``), under
    the limits of the benchmark's LAS fold; every rank holds the same
    map."""
    inp, port, _ = world
    voxel_map, compare = _bench("reference/voxel_map"), \
        _bench("reference/compare")
    cfg = json.loads((BENCH / "configs" / "ahn4-block-2x2.json")
                     .read_text())
    limits = json.loads((BENCH / "workloads" / "las-fold.json")
                        .read_text())["limits"]
    local, inten, cls = (torch.from_numpy(a) for a in inp["sheet_block"])
    ref = voxel_map.fold_map(local, inten, cls, cfg["scale"],
                             [float(SHEET[0][0]), float(SHEET[0][1]), 0.0],
                             0.5, 20)
    got = port[0]["ingest"]["sheet"]
    hi, lo = (torch.from_numpy(k) for k in got["keys"])
    key = voxel_map.linear_code(voxel_map.cells_of_morton60(hi, lo))
    order = torch.argsort(key)
    mine = {"key": key[order],
            "counts": torch.from_numpy(got["counts"]).long()[order],
            "centroid": torch.from_numpy(got["data"][POS]).double()[order],
            "intensity": torch.from_numpy(
                got["data"][INT].astype(np.int64))[order],
            "classification": torch.from_numpy(
                got["data"][CLS].astype(np.int64))[order]}
    checks, failed = compare.worst([compare.keyed(mine, ref)], limits)
    assert failed == 0, checks
    assert int(mine["counts"].sum()) == local.shape[0]
    for res in port[1:]:
        other = res["ingest"]["sheet"]
        for name, col in got["data"].items():
            np.testing.assert_array_equal(other["data"][name], col)
        for a, b in zip(other["keys"], got["keys"]):
            np.testing.assert_array_equal(a, b)


def test_span_seconds_has_five_phases(world):
    _, port, _ = world
    for res in port:
        spans = res["ingest"]["sheet"]["spans"]
        assert list(spans) == ["read", "upload", "voxelize", "gather",
                               "merge"]
        assert all(v >= 0 for v in spans.values())
