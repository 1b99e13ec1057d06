"""The sheet fold (``ahn4-sheet-sharded``) on four gloo ranks on the CPU,
through ``world.py``, from a copy of the benchmark whose configuration and
traffic files are small: the merged map agrees with the plain reference on
every rank, the traced run reports the cell's per-layer metrics, the
control comes out not correct, and so does a run whose timed path is
broken underneath on one rank (``sheet_fault.py``): half of one rank's
shard left out, rank 0's merged map altered, one other rank's map
differing from the rest.

The ``card`` test runs the control at the cell's own size on four cards
through ``run.py`` (exit code 3 with fewer)."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import BENCH, CHECKOUT, SEED, bench_json, cell, need_card
import harness
import world

NAME = "ahn4-sheet-sharded"
#: the block cut to a size a CPU test holds: four 60 m x 75 m sub-tiles
#: side by side at 3 points a square metre, folded in 512-row tiles
CORNERS = [[136000, 455000], [136060, 455000], [136000, 455075],
           [136060, 455075]]
FAULTS = {"half_left_out": 1, "map_altered": 0, "rank_differs": 2}


def sheet_copy(dest: Path) -> Path:
    """A copy of the benchmark's folder under ``dest`` with the cell's
    configuration and traffic files cut small, under the same names, one
    traffic file a fault (``sheet-fold-<fault>.json``, driven by the
    fault driver), and the cells' own files as they are."""
    root = dest / "benchmark"
    shutil.copytree(BENCH, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    c = cell(NAME)
    cfg = json.loads((BENCH / "configs" / f"{c['config']}.json").read_text())
    cfg.update(size_m=[60, 75], points_per_m2=3, sub_tiles=CORNERS)
    (root / "configs" / f"{c['config']}.json").write_text(json.dumps(cfg))
    tr = json.loads((BENCH / "workloads" / f"{c['traffic']}.json")
                    .read_text())
    (root / "workloads" / f"{c['traffic']}.json").write_text(json.dumps(tr))
    shutil.copy(BENCH / "tests" / "sheet_fault.py",
                root / "drivers" / "sheet_fault.py")
    for fault, rank in FAULTS.items():
        (root / "workloads" / f"sheet-fold-{fault}.json").write_text(
            json.dumps(dict(tr, driver="sheet_fault",
                            fault={"kind": fault, "rank": rank})))
    return root


@pytest.fixture(scope="module")
def sheet_root(tmp_path_factory):
    return sheet_copy(tmp_path_factory.mktemp("sheet"))


def run_sheet(root, traffic=None, trace=False, control=False):
    c = dict(cell(NAME))
    if traffic is not None:
        c["traffic"] = traffic
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "ROOT", root)
        return world.run_ranks(bench_json(), c, SEED, 1.0, trace, 4, "cpu",
                               control=control, limit_s=110)


@pytest.mark.time_limit(120)
def test_sheet_fold_agrees_with_reference_on_every_rank(sheet_root):
    out = run_sheet(sheet_root)
    assert out["correct"], out["checks"]
    assert out["checks"]["ranks_differing"]["value"] == 0
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"fold_mpoints_per_s", "setup_s"}
    assert out["device"]["count"] == 4
    # each rank decoded its own quarter of the block and no more
    per = out["window"]["ranks_per_fold"]
    assert len(per) == 4
    total = sum(r["points_decoded"] for r in per)
    assert total == pytest.approx(4 * 60 * 75 * 3)
    assert max(r["points_decoded"] for r in per) <= -(-total // 4)


@pytest.mark.time_limit(120)
def test_sheet_fold_traced_reports_its_layers(sheet_root):
    out = run_sheet(sheet_root, trace=True)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in bench_json()["per_layer"]
            if NAME in m.get("workloads", [])}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        assert m["value"] > 0, name


@pytest.mark.time_limit(120)
def test_sheet_control_is_not_correct(sheet_root):
    out = run_sheet(sheet_root, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.time_limit(120)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_sheet_fault_is_caught(sheet_root, fault):
    out = run_sheet(sheet_root, traffic=f"sheet-fold-{fault}")
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1
    if fault == "rank_differs":
        # rank 0's own map is right: only the ranks' checksums tell
        assert out["checks"]["centroid_gap_m"]["value"] <= 0.1
        assert out["checks"]["ranks_differing"]["value"] == 1


@pytest.mark.card
@pytest.mark.time_limit(600)
def test_sheet_control_full_size_on_four_cards():
    """The control at the cell's own size through ``run.py`` on four
    cards: not correct.  With fewer cards ``run.py`` exits with code 3."""
    need_card()
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        NAME, "--seed", str(SEED), "--seconds", "1",
                        "--control", "1"], capture_output=True, text=True,
                       cwd=CHECKOUT, timeout=580)
    if torch.cuda.device_count() < 4:
        assert p.returncode == 3, p.stderr[-2000:]
        return
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().split("\n")[-1])
    print(json.dumps(out))
    assert not out["correct"], out["checks"]
