"""The port's examples (``examples/torch/``), each ``main`` run on
``device="cpu"`` at its original's sizes, and checked where the original
prints a result: the building filter agrees with the host's, the bounds
and the ICP translations are the ones the data was made with, the written
files read back.  The distributed example starts its own world of two
gloo ranks (``parallel.spawn.run_world``), each with the original's 4 096
points a device; the examples import nothing of JAX or the JAX
package."""

import importlib.util
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
# the distributed example last: its world runs while the others do
NAMES = ("algorithms_tour", "basic_point_buffers", "gen_test_data", "las_io",
         "layout_conversion", "simple_filtering", "write_3dtiles",
         "distributed_registration")


def _load(name):
    """The example as a module importable by name (the distributed one's
    ranks import it again in their own processes)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_every_example_is_ported_and_imports_only_the_port():
    originals = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert sorted(NAMES) == originals
    for name in NAMES:
        text = (EXAMPLES / f"{name}.py").read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|pasture_tpu)\b",
                             text, re.M), name
        assert "--device" in text, name


@pytest.fixture(scope="module")
def las_file(tmp_path_factory):
    """A 10-point format-1 LAS file as the reference's fixtures are."""
    gen = _load("gen_test_data")
    from pasture_tpu_torch.buffers.host import HostPointBuffer
    from pasture_tpu_torch.io.las import LasWriter
    from pasture_tpu_torch.io.las.header import LasPointFormat
    from pasture_tpu_torch.io.las.layout import point_schema_from_las_format

    fmt = LasPointFormat(1)
    schema = point_schema_from_las_format(fmt)
    path = tmp_path_factory.mktemp("examples") / "10_points_format_1.las"
    with LasWriter(path, schema) as w:
        w.write(HostPointBuffer.from_columns(schema,
                                             gen.fixture_columns(fmt)))
    return path


@pytest.fixture(scope="module")
def distributed_run():
    """The distributed example's ``main(2, "cpu")``, started in a thread at
    the first example, read at its own."""
    with ThreadPoolExecutor(max_workers=1) as ex:
        yield ex.submit(_load("distributed_registration").main, 2, "cpu")


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name, las_file, distributed_run, tmp_path,
                                 capsys):
    mod = _load(name)
    if name == "basic_point_buffers":
        mn, mx = mod.main(device="cpu")
        rng = np.random.default_rng(0)
        pos = rng.uniform(-10, 10, (1000, 3)).astype(np.float32)
        np.testing.assert_array_equal(mn, pos.min(0))
        np.testing.assert_array_equal(mx, pos.max(0))
    elif name == "simple_filtering":
        assert mod.main(device="cpu") > 0
    elif name == "layout_conversion":
        converted, out = mod.main(device="cpu")
        assert out["ReturnNumber"].max() <= 3
    elif name == "algorithms_tour":
        got = mod.main(device="cpu")
        assert got["inliers"] >= 2000 and got["nz"] > 0.9
    elif name == "gen_test_data":
        written = mod.main(tmp_path / "data", device="cpu")
        assert len(written) == 11 + 6
    elif name == "las_io":
        buffer, batch = mod.main(str(las_file), str(tmp_path / "out.laz"),
                                 device="cpu")
        assert len(buffer) == int(batch.count) == 10
        assert (tmp_path / "out.laz").stat().st_size > 0
    elif name == "write_3dtiles":
        assert mod.main(str(las_file), tmp_path / "tiles", device="cpu") >= 2
        assert (tmp_path / "tiles" / "tileset.json").exists()
    else:
        # the ranks print in their own processes
        ranks = distributed_run.result()
        for r in ranks:
            np.testing.assert_allclose(r["translation"], [0.4, -0.2, 0.1],
                                       atol=5e-3)
            np.testing.assert_allclose(r["partitioned_translation"],
                                       [0.4, -0.2, 0.1], atol=5e-3)
            assert r["normals"].sum() == 4096 * 2
        return
    assert capsys.readouterr().out
