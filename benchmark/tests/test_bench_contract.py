"""``BENCHMARK.json`` keeps to its format; the harness imports neither JAX
nor the package the program was ported from, and the reference nothing of
the program; a cell, a configuration and a metric added as new files are
found by name; the trace reader's arithmetic."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import BENCH, CHECKOUT, bench_json, tiny_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_bench_json_names_units_and_keys():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    cells = {c["name"] for c in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert (CHECKOUT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (BENCH / "workloads" / f"{w['traffic']}.json").is_file()
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if m["name"] != "setup_s":
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for name in cells:
        reports = [m for m in b["end_to_end"]
                   if name in m.get("workloads", [name])]
        assert len(reports) >= 2
        assert any(name in m["workloads"] for m in b["per_layer"])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_bench_imports_no_jax_and_reference_nothing_of_the_program():
    for path in BENCH.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "pasture_tpu"}, path
        if "reference" in path.parts:
            assert "pasture_tpu_torch" not in tops, path


def test_bench_run_loads_no_jax():
    """What a run loads, in a process of its own (the harness checks the
    same once its window has closed)."""
    code = ("import sys; sys.argv = ['x']; sys.path[:0] = [%r, %r, %r];"
            "import harness, run, conftest, torch;"
            "from drivers import las_fold, odometry, resident_step;"
            "import pasture_tpu_torch.pipeline, pasture_tpu_torch.io.streaming;"
            "print(harness.forbidden_modules())"
            % (str(CHECKOUT), str(BENCH), str(BENCH / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split("\n")[-2]
    assert out == "[]"


#: run.py's main in a process that skips the look for a card, runs the
#: cell on the CPU from a copy with small files, and has every driver's
#: check load a module of the package the program was ported from
_FORBIDDEN_IN_CHECK = """
import sys, types
sys.path[:0] = [%r, %r]
import torch, run, harness
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
harness.ROOT = __import__("pathlib").Path(%r)
real_run, real_load = harness.run_cell, harness.load_module
harness.run_cell = lambda b, c, s, secs, t, dev, control=False: real_run(
    b, c, s, secs, t, "cpu", control=control)
def load(kind, name):
    mod = real_load(kind, name)
    if kind == "drivers":
        check = mod.Driver.check
        def loads_forbidden(self, control):
            sys.modules["pasture_tpu"] = types.ModuleType("pasture_tpu")
            return check(self, control)
        mod.Driver.check = loads_forbidden
    return mod
harness.load_module = load
sys.exit(run.main(["--workload", "ahn4-resident-step", "--seed", "7",
                   "--seconds", "0.3", "--trace", "0",
                   "--control", sys.argv[1]]))
"""


@pytest.mark.parametrize("control", ["0", "1"], ids=["window", "control"])
def test_bench_run_stops_on_a_forbidden_module_loaded_in_the_check(
        control, tmp_path):
    """A forbidden module loaded after the window, in the check, stops the
    run with exit code 4 and no result, in a run with a window and in a
    control run alike."""
    root = tiny_copy(tmp_path)
    code = _FORBIDDEN_IN_CHECK % (str(CHECKOUT), str(BENCH), str(root))
    p = subprocess.run([sys.executable, "-c", code, control],
                       capture_output=True, text=True, cwd=CHECKOUT)
    assert p.returncode == 4, p.stderr[-2000:]
    assert "pasture_tpu" in p.stderr
    assert not p.stdout.strip()


def test_bench_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files to a copy of the benchmark run without an edit to any file
    that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "pasture_tpu_torch").symlink_to(CHECKOUT / "pasture_tpu_torch")
    b = bench_json()
    cfg = json.loads((BENCH / "configs" / "ahn4-tile.json").read_text())
    cfg.update(name="tiny-tile", size_m=[120, 100], points_per_m2=1.0)
    (root / "benchmark" / "configs" / "tiny-tile.json").write_text(
        json.dumps(cfg))
    tr = json.loads((BENCH / "workloads" / "las-fold.json").read_text())
    tr.update(chunk_points=8192, checked_units=1, trace_units=1)
    (root / "benchmark" / "workloads" / "small-fold.json").write_text(
        json.dumps(tr))
    (root / "benchmark" / "metrics" / "folds_traced.fold.py").write_text(
        "def read(run):\n"
        "    return run.total('folds') if run.device_busy_s is not None "
        "else None\n")
    b["configs"].append({"name": "tiny-tile", "source": "x",
                         "file": "benchmark/configs/tiny-tile.json",
                         "reduced": [], "why": "x"})
    new = {"name": "tiny-fold", "config": "tiny-tile",
           "traffic": "small-fold", "chips": 1, "why": "x"}
    b["workloads"].append(new)
    b["end_to_end"][0]["workloads"].append("tiny-fold")
    b["per_layer"].append({"name": "folds_traced.fold", "unit": "folds",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "fold_mpoints_per_s",
                           "workloads": ["tiny-fold"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, sys; sys.path[:0] = [%r, %r];"
        "import harness;"
        "b = json.load(open(%r));"
        "c = [w for w in b['workloads'] if w['name'] == 'tiny-fold'][0];"
        "print(json.dumps([harness.run_cell(b, c, 5, 0.5, t, 'cpu')"
        " for t in (False, True)]))"
        % (str(root), str(root / "benchmark"), str(root / "BENCHMARK.json")))
    out = json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=root).stdout.split("\n")[-2])
    plain, traced = out
    assert plain["correct"] and "fold_mpoints_per_s" in plain["metrics"]
    assert traced["metrics"]["folds_traced.fold"]["value"] == 1.0


def test_bench_trace_reader(tmp_path):
    import harness
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 100.0, "dur": 100.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 100.0,
           "dur": 40.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpy",
           "ts": 150.0, "dur": 50.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 110.0,
           "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 120.0,
           "dur": 20.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
           "ts": 190.0, "dur": 30.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    run = harness.Run()
    info = harness.read_trace(str(path), run)
    # busy: [110, 140] and [190, 200] inside the window
    assert run.device_busy_s == pytest.approx(40e-6)
    assert info["window_s"] == pytest.approx(100e-6)
    assert len(run.kernels) == 2
    gaps = dict(info["breakdown"]["idle_gaps"])
    assert gaps["cudaMemcpy"] == pytest.approx(50e-6)
    assert gaps["aten::sort"] == pytest.approx(10e-6)
    ops = dict(info["breakdown"]["device_ops"])
    assert ops["Memcpy DtoH"] == pytest.approx(10e-6)
