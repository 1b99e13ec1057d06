"""Shared set-up of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``).  Tests marked ``card`` need a CUDA
device and skip without one; the check is made inside each test."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
for p in (str(CHECKOUT), str(BENCH), str(BENCH / "metrics")):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

#: a seed past 32 signed bits, as the benchmark's runs get
SEED = 2 ** 31 + 4242


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card only")


def bench_json():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name):
    return {c["name"]: c for c in bench_json()["workloads"]}[name]


def tiny(name):
    """``(config, traffic)`` of cell ``name`` cut to a size a CPU test
    holds: a 300 m x 260 m tile at 1.5 points a square metre, folded in
    chunks of 16 384 and stepped on 128 m squares; scans of 200 azimuths."""
    c = cell(name)
    cfg = json.loads((BENCH / "configs" / f"{c['config']}.json").read_text())
    tr = json.loads((BENCH / "workloads" / f"{c['traffic']}.json")
                    .read_text())
    if c["config"] == "ahn4-tile":
        cfg["size_m"] = [300, 260]
        cfg["points_per_m2"] = 1.5
        if "chunk_points" in tr:
            tr["chunk_points"] = 16384
        if tr["driver"] == "resident_step":
            tr["grid_bits"] = 8
    else:
        cfg["sensor"]["azimuths"] = 200
        tr.update(warm_scans=2, checked_units=2, trace_units=3)
    return cfg, tr


def tiny_copy(dest: Path) -> Path:
    """A copy of the benchmark's folder under ``dest`` whose configuration
    and traffic files are those of :func:`tiny`, under the same names."""
    root = dest / "benchmark"
    shutil.copytree(BENCH, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for c in bench_json()["workloads"]:
        cfg, tr = tiny(c["name"])
        (root / "configs" / f"{c['config']}.json").write_text(json.dumps(cfg))
        (root / "workloads" / f"{c['traffic']}.json").write_text(
            json.dumps(tr))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


def run_tiny(root: Path, name, seconds=1.0, trace=False, control=False):
    """One run of cell ``name`` on the CPU, its files read from ``root``
    (a :func:`tiny_copy`)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "ROOT", root)
        return harness.run_cell(bench_json(), cell(name), SEED, seconds,
                                trace, "cpu", control=control)
