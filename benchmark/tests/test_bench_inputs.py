"""The generators repeat from the seed; the LAS writer's files read back
through the program's reader; the roofline counts reproduce the kernel
table's bounds."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import roofline
from conftest import SEED, tiny
from lasfile import write_las
from scenes import ahn4, kitti


def test_bench_tile_repeats_from_seed():
    cfg, _ = tiny("ahn4-las-fold")
    a = ahn4.make_tile(cfg, SEED, "cpu")
    b = ahn4.make_tile(cfg, SEED, "cpu")
    c = ahn4.make_tile(cfg, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["local"], c["local"])
    # one point a square metre, a second on half of them
    assert abs(a["local"].shape[0] - 300 * 260 * 1.5) < 2000


def test_bench_tile_blocks_are_runs_of_the_morton_order():
    cfg, _ = tiny("ahn4-resident-step")
    t = ahn4.make_tile(cfg, SEED, "cpu")
    runs = ahn4.block_runs(t["local"], 128000)
    assert sum(n for _, n in runs) == t["local"].shape[0]
    blocks = {(int(t["local"][s, 0]) // 128000,
               int(t["local"][s, 1]) // 128000) for s, _ in runs}
    assert len(blocks) == len(runs) == 9        # each square one run
    for s, n in runs:
        loc = t["local"][s:s + n]
        assert int((loc[:, :2].max(0).values - loc[:, :2].min(0).values)
                   .max()) < 128000


def test_bench_scans_repeat_from_seed():
    cfg, _ = tiny("kitti-odometry")
    a = kitti.make_scans(cfg, SEED, "cpu", count=3)
    b = kitti.make_scans(cfg, SEED, "cpu", count=3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    # 64 beams x 200 azimuths: almost every ray hits within range
    assert all(0.8 * 64 * 200 < len(x) <= 64 * 200 for x in a)


def test_bench_las_writer_reads_back_through_the_program(tmp_path):
    from pasture_tpu_torch.io.las.reader import LasReader
    from pasture_tpu_torch.layout import attributes as att
    from pasture_tpu_torch.layout.schema import PointSchema
    cfg, _ = tiny("ahn4-las-fold")
    t = ahn4.make_tile(cfg, SEED, "cpu")
    path = tmp_path / "t.las"
    write_las(path, t["local"].numpy(), t["intensity"].numpy(),
              t["classification"].numpy(), scale=cfg["scale"],
              offset=cfg["offset"])
    schema = PointSchema.from_attributes(
        [att.POSITION_3D, att.INTENSITY, att.CLASSIFICATION])
    with LasReader(path) as r:
        header = r.header
        buf = r.read(1 << 30, schema=schema)
        bounds = r.get_metadata().bounds()
    assert header.point_format.number == 6
    assert header.point_record_length == 30
    assert len(buf) == t["local"].shape[0]
    # map coordinates in RD New, as the file's scale and offset give them
    world = t["local"].numpy() * 0.001 + np.asarray(cfg["offset"])
    assert world[:, 1].min() >= 455000.0
    assert np.array_equal(buf.get(att.POSITION_3D.name), world)
    assert np.array_equal(buf.get(att.INTENSITY.name), t["intensity"].numpy())
    assert np.array_equal(buf.get(att.CLASSIFICATION.name),
                          t["classification"].numpy())
    assert np.array_equal(bounds.min, world.min(0))


@pytest.mark.parametrize("fn, want_ms", [
    (lambda n: roofline.k1_world_bounds(n), 0.0150),
    (lambda n: roofline.k2_exact_local_head(n), 0.0250),
    (lambda n: roofline.k4_tile_sort(n, 3), 0.0300),
    (lambda n: roofline.k3_voxel_reduce(n), 0.0351),
], ids=["K1", "K2", "K4", "K3"])
def test_bench_roofline_reproduces_the_kernel_table(fn, want_ms):
    n = 8192 * 512
    assert round(roofline.bound_seconds(fn(n)) * 1e3, 4) == want_ms
