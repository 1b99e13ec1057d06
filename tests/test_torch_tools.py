"""The port's tools and utilities against the JAX package's: ``info`` (plain
and ``--detailed``) prints the same lines but the timing line, ``convert``
(LAS -> LAZ -> ``.pnts`` with an attribute subset, ASCII -> LAS, LAS ->
ASCII) writes the same bytes, ``random_point_buffer`` draws the same
columns for a seed, ``load_pytree`` reads the JAX package's nested-dict
``.npz`` with every leaf in place, and ``roofline_estimate`` carries the
card's peaks.  Files are written here from seeded numpy buffers; the first
LAZ write in a process builds the port's LASzip codec."""

import collections

import numpy as np
import pytest
import torch

from pasture_tpu import testing as jtesting
from pasture_tpu.io import write_all as j_write_all
from pasture_tpu.tools import convert as jconvert
from pasture_tpu.tools import info as jinfo
from pasture_tpu.utils import checkpoint as jcheckpoint

from pasture_tpu_torch import testing as ptesting
from pasture_tpu_torch.io import read_all
from pasture_tpu_torch.tools import convert as pconvert
from pasture_tpu_torch.tools import info as pinfo
from pasture_tpu_torch.utils import checkpoint as pcheckpoint
from pasture_tpu_torch.utils import profiling as pprofiling


@pytest.fixture(scope="module")
def las_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tools") / "cloud.las"
    j_write_all(jtesting.random_point_buffer(2500, seed=3), path)
    return path


def _lines(main, argv, capsys):
    assert main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("(") and lines[-1].endswith("s)")
    return lines[:-1]                    # all but the timing line


@pytest.mark.parametrize("detailed", [False, True])
@pytest.mark.parametrize("suffix", ["las", "pnts"])
def test_info_prints_the_jax_package_lines(las_file, tmp_path, capsys,
                                            detailed, suffix):
    path = las_file
    if suffix == "pnts":
        path = tmp_path / "cloud.pnts"
        assert jconvert.main([str(las_file), str(path)]) == 0
        capsys.readouterr()
    argv = [str(path)] + (["--detailed"] if detailed else [])
    jlines = _lines(jinfo.main, argv, capsys)
    plines = _lines(pinfo.main, argv, capsys)
    assert plines == jlines
    assert ("Attribute statistics:" in plines) == detailed


def _convert_both(argv_of, tmp_path, capsys):
    """Run both packages' convert on the same input, into files of their
    own; returns the two output paths."""
    out = {}
    for tag, main in (("j", jconvert.main), ("p", pconvert.main)):
        argv = argv_of(tmp_path / tag)
        (tmp_path / tag).mkdir(exist_ok=True)
        assert main(argv) == 0
        out[tag] = argv[1]
    jline, pline = capsys.readouterr().out.splitlines()[-2:]
    assert pline.rsplit("(", 1)[0].replace(str(tmp_path / "p"), "") == \
        jline.rsplit("(", 1)[0].replace(str(tmp_path / "j"), "")
    return out["j"], out["p"]


def test_convert_las_to_laz_to_pnts(las_file, tmp_path, capsys):
    j, p = _convert_both(lambda d: [str(las_file), str(d / "x.laz")],
                         tmp_path, capsys)
    assert open(p, "rb").read() == open(j, "rb").read()
    j2, p2 = _convert_both(
        lambda d: [str(d / "x.laz"), str(d / "x.pnts"), "--attributes",
                   "Position3D", "ColorRGB"], tmp_path, capsys)
    assert open(p2, "rb").read() == open(j2, "rb").read()
    back = read_all(p2)
    assert back.schema.names == ("Position3D", "ColorRGB") and \
        len(back) == 2500


def test_convert_ascii_to_las_and_back(las_file, tmp_path, capsys):
    fmt = ["--ascii-format", "xyziRGB"]
    j, p = _convert_both(lambda d: [str(las_file), str(d / "x.txt")] + fmt,
                         tmp_path, capsys)
    assert open(p, "rb").read() == open(j, "rb").read()
    j2, p2 = _convert_both(lambda d: [str(d / "x.txt"), str(d / "y.las")]
                           + fmt, tmp_path, capsys)
    assert open(p2, "rb").read() == open(j2, "rb").read()
    with pytest.raises(SystemExit):
        pconvert.main([str(tmp_path / "p" / "x.txt"), "z.las"])


@pytest.mark.parametrize("seed,n", [(0, 257), (9, 1000)])
def test_random_point_buffer_draws_the_same_columns(seed, n):
    jbuf = jtesting.random_point_buffer(n, seed=seed, position_range=7.5)
    pbuf = ptesting.random_point_buffer(n, seed=seed, position_range=7.5)
    assert pbuf.schema.names == jbuf.schema.names == \
        ptesting.DEFAULT_TEST_SCHEMA.names
    for name in jbuf.schema.names:
        assert pbuf.get(name).dtype == jbuf.get(name).dtype
        np.testing.assert_array_equal(pbuf.get(name), jbuf.get(name))


def _tree():
    rng = np.random.default_rng(0)
    return {
        "zeta": rng.normal(size=(3, 2)),
        "alpha": {"poses": rng.normal(size=(4, 4, 4)).astype(np.float32),
                  "keys": np.arange(5, dtype=np.uint32),
                  "empty": None},
        "map": [rng.integers(0, 9, 7), (np.float64(2.5), np.ones(2))],
        "ordered": collections.OrderedDict(
            [("q", np.full(2, 7)), ("b", np.zeros(1, np.int8))]),
    }


def test_load_pytree_reads_the_jax_package_npz(tmp_path):
    tree = _tree()
    path = tmp_path / "state.npz"
    jcheckpoint.save_pytree(tree, path)
    like = _tree()
    like["alpha"]["poses"] = torch.zeros(4, 4, 4)
    back = pcheckpoint.load_pytree(path, like)
    assert isinstance(back["alpha"]["poses"], torch.Tensor)
    np.testing.assert_array_equal(back["alpha"]["poses"].numpy(),
                                  tree["alpha"]["poses"])
    np.testing.assert_array_equal(back["alpha"]["keys"],
                                  tree["alpha"]["keys"])
    assert back["alpha"]["empty"] is None
    np.testing.assert_array_equal(back["zeta"], tree["zeta"])
    np.testing.assert_array_equal(back["map"][0], tree["map"][0])
    assert float(back["map"][1][0]) == 2.5 and \
        isinstance(back["map"][1], tuple)
    assert list(back["ordered"]) == ["q", "b"]
    np.testing.assert_array_equal(back["ordered"]["q"], np.full(2, 7))
    # and the JAX package reads the port's file the same way
    pcheckpoint.save_pytree(tree, tmp_path / "port.npz")
    jback = jcheckpoint.load_pytree(tmp_path / "port.npz", _tree())
    for a, b in zip(pcheckpoint._flatten(jback), pcheckpoint._flatten(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_pytree_round_trip_is_exact(tmp_path, suffix):
    tree = {"b": torch.arange(6, dtype=torch.int64).reshape(2, 3),
            "a": [torch.linspace(0, 1, 5, dtype=torch.float64),
                  np.arange(4, dtype=np.uint16)]}
    path = tmp_path / f"ckpt{suffix}"
    pcheckpoint.save_pytree(tree, path)
    back = pcheckpoint.load_pytree(path, tree)
    assert torch.equal(back["b"], tree["b"])
    assert torch.equal(back["a"][0], tree["a"][0])
    np.testing.assert_array_equal(back["a"][1], tree["a"][1])
    assert back["a"][1].dtype == np.uint16


def test_roofline_estimate_carries_the_h100_peaks(tmp_path):
    est = pprofiling.roofline_estimate(4 << 20, 16, 0.0)
    assert est.hbm_bound_s == pytest.approx((4 << 20) * 16 / 3.35e12)
    assert est.bound == "HBM"
    est = pprofiling.roofline_estimate(1 << 20, 4, 1e4)
    assert est.compute_bound_s == pytest.approx((1 << 20) * 1e4 / 67e12)
    assert est.bound == "compute"
    names = [n for n in vars(pprofiling) if n.isupper()]
    assert names and not [n for n in names if "V5E" in n]
    with pprofiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
