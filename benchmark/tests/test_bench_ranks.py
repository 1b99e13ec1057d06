"""The rank path of ``world.py``: a cell on several cards runs as one rank a
card in one world.  On the CPU the probe (``tests/probe/``, a cell of a
copy of the benchmark only) runs on four gloo ranks, given ``"cpu"``
directly: every rank runs the same units, the sums are right, a unit's
seconds are the slowest rank's, each rank reports its facts and its trace,
and a rank that raises, dies, hangs or loads JAX ends the run with no
result, within its time limit.  A run on one card starts neither a
process nor a process group.  The ``card`` tests run the probe through
``run.py`` on four cards (exit code 3 with fewer) and a world of one on
``cuda:0``."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import (BENCH, CHECKOUT, SEED, need_card, probe_checkout,
                      tiny_copy)
import harness
import world

#: what each probe cell's traffic changes: one fault on one rank
CELLS = {
    "probe": {},
    "probe-slow": {"fault": {"rank": 2, "kind": "slow", "seconds": 0.05}},
    "probe-setup-raises": {"fault": {"rank": 1, "where": "setup",
                                     "kind": "raise"}},
    "probe-unit-raises": {"fault": {"rank": 3, "where": "unit", "at": 2,
                                    "kind": "raise"}},
    "probe-check-raises": {"fault": {"rank": 2, "where": "check",
                                     "kind": "raise"}},
    "probe-killed": {"fault": {"rank": 2, "where": "unit", "at": 3,
                               "kind": "die"}},
    "probe-stuck": {"fault": {"rank": 1, "where": "unit", "at": 2,
                              "kind": "skip"}},
    "probe-hangs": {"fault": {"rank": 3, "where": "unit", "at": 1,
                              "kind": "hang"}},
    "probe-jax": {"fault": {"rank": 1, "where": "check", "kind": "jax"}},
}


@pytest.fixture(scope="module")
def probe_root(tmp_path_factory):
    return probe_checkout(tmp_path_factory.mktemp("probe"), CELLS)


def run_probe(root, name, seconds=1.0, trace=False, control=False, n=4,
              device="cpu", **kw):
    """One run of probe cell ``name`` from checkout ``root`` on ``n``
    ranks."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = {c["name"]: c for c in bench["workloads"]}[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "ROOT", root / "benchmark")
        return world.run_ranks(bench, cell, SEED, seconds, trace, n, device,
                               control=control, **kw)


@pytest.fixture(scope="module")
def slow_run(probe_root):
    """A window in which rank 2 sleeps 50 ms after each unit's
    collective: the others' units end without that wait."""
    return run_probe(probe_root, "probe-slow")


@pytest.mark.time_limit(120)
def test_ranks_run_the_same_units_and_sums_are_right(slow_run):
    out = slow_run
    assert out["correct"], out["checks"]
    assert out["checks"]["sum_gap"]["value"] == 0
    assert out["checks"]["unit_count_spread"]["value"] == 0
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert [r["units"] for r in out["window"]["ranks"]] \
        == [out["attempted"]] * 4
    assert set(out["metrics"]) == {"probe_units_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.time_limit(120)
def test_a_units_seconds_are_the_slowest_ranks(slow_run):
    w = slow_run["window"]
    assert w["unit_s_min"] >= 0.05
    # the window is rank 0's clock over every unit
    assert w["seconds"] >= w["units"] * 0.05


@pytest.mark.time_limit(120)
def test_every_rank_reports_its_facts(slow_run):
    out = slow_run
    assert [r["rank"] for r in out["window"]["ranks"]] == [0, 1, 2, 3]
    assert out["device"] == {"platform": "cpu", "kind": "cpu", "count": 4,
                             "memory_peak_bytes": 0}
    # the launching process's age: every rank's start counts
    assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.time_limit(120)
def test_traced_run_gives_each_ranks_busy_seconds(probe_root):
    out = run_probe(probe_root, "probe", trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 5
    ranks = out["window"]["ranks"]
    assert len(ranks) == 4
    for r in ranks:
        assert r["busy_s"] is not None and r["window_s"] > 0
    assert 0 <= out["device"]["busy_s"] <= out["device"]["window_s"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(out["metrics"]) == {"probe_idle_share"}


@pytest.mark.time_limit(120)
def test_control_runs_through_the_ranks(probe_root):
    out = run_probe(probe_root, "probe", control=True)
    assert not out["correct"], out["checks"]
    assert "metrics" not in out and "device" not in out


@pytest.mark.time_limit(120)
@pytest.mark.parametrize("name, said", [
    ("probe-setup-raises", "rank 1 raised in its setup"),
    ("probe-unit-raises", "rank 3 raised in its unit"),
    ("probe-check-raises", "rank 2 raised in its check"),
    ("probe-killed", "exited with codes [-9]"),
])
def test_a_failing_rank_ends_the_run(probe_root, name, said):
    t0 = time.monotonic()
    with pytest.raises(world.RankFailed) as e:
        run_probe(probe_root, name, timeout_s=20, limit_s=60)
    assert said in str(e.value)
    assert time.monotonic() - t0 < 60


@pytest.mark.time_limit(120)
def test_a_rank_stuck_in_a_collective_is_ended_by_the_timeout(probe_root):
    """Rank 1 leaves out one unit's all-reduce: the others wait in it
    until the collectives' timeout raises."""
    t0 = time.monotonic()
    with pytest.raises(world.RankFailed) as e:
        run_probe(probe_root, "probe-stuck", timeout_s=5, limit_s=90)
    assert "failed" in str(e.value)
    assert time.monotonic() - t0 < 60


@pytest.mark.time_limit(120)
def test_a_rank_past_the_limit_is_killed(probe_root):
    t0 = time.monotonic()
    with pytest.raises(world.RankFailed) as e:
        run_probe(probe_root, "probe-hangs", timeout_s=300, limit_s=20)
    assert "still running after the run's limit of 20 s" in str(e.value)
    assert time.monotonic() - t0 < 60


#: run.py's main in a process that takes the card's cells to the CPU:
#: a cell on four cards runs on four gloo ranks, one card on "cpu"
_RUN_ON_THE_CPU = """
import sys
sys.path[:0] = [%r, %r]
import torch, run, harness, world
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 4
harness.ROOT = __import__("pathlib").Path(%r)
real_cell, real_ranks = harness.run_cell, world.run_ranks
harness.run_cell = lambda b, c, s, secs, t, dev, control=False: real_cell(
    b, c, s, secs, t, "cpu", control=control)
world.run_ranks = lambda b, c, s, secs, t, n, dev, control=False: \\
    real_ranks(b, c, s, secs, t, n, "cpu", control=control)
%s
sys.exit(run.main(sys.argv[1:]))
"""


@pytest.mark.time_limit(120)
def test_a_rank_that_loads_jax_ends_the_run_with_code_4(probe_root):
    code = _RUN_ON_THE_CPU % (str(probe_root), str(probe_root / "benchmark"),
                              str(probe_root / "benchmark"), "")
    p = subprocess.run([sys.executable, "-c", code, "--workload",
                        "probe-jax", "--seed", str(SEED), "--seconds", "0.5"],
                       capture_output=True, text=True, cwd=probe_root,
                       timeout=100)
    assert p.returncode == 4, p.stderr[-2000:]
    assert "rank 1: jax" in p.stderr
    assert not p.stdout.strip()


@pytest.mark.time_limit(120)
def test_a_failing_rank_ends_run_py_with_no_result(probe_root):
    code = _RUN_ON_THE_CPU % (str(probe_root), str(probe_root / "benchmark"),
                              str(probe_root / "benchmark"), "")
    p = subprocess.run([sys.executable, "-c", code, "--workload",
                        "probe-unit-raises", "--seed", str(SEED),
                        "--seconds", "0.5"],
                       capture_output=True, text=True, cwd=probe_root,
                       timeout=100)
    assert p.returncode == 5, p.stderr[-2000:]
    assert "probe fault: rank 3 raised in its unit" in p.stderr
    assert not p.stdout.strip()


#: the same, for a cell on one card, with the window watched: how many
#: processes this one has started, and whether a process group is up
_WATCH_ONE_CARD = """
import os
import torch.distributed as dist
seen = []
real_units = harness.run_units
def children():
    n = 0
    for p in os.listdir("/proc"):
        try:
            stat = open(f"/proc/{p}/stat").read() if p.isdigit() else ")"
        except OSError:  # a process that ended meanwhile
            continue
        n += stat.rsplit(")", 1)[1].split()[1:2] == [str(os.getpid())]
    return n
def run_units(driver, run, seconds, count, device):
    seen.append({"children": children(),
                 "group": dist.is_available() and dist.is_initialized()})
    return real_units(driver, run, seconds, count, device)
harness.run_units = run_units
import atexit
atexit.register(lambda: print("WATCHED", seen, file=sys.stderr))
"""


@pytest.mark.time_limit(180)
def test_a_one_card_run_starts_no_process_and_no_group(tmp_path):
    root = tiny_copy(tmp_path)
    code = _RUN_ON_THE_CPU % (str(CHECKOUT), str(BENCH), str(root),
                              _WATCH_ONE_CARD)
    p = subprocess.run([sys.executable, "-c", code, "--workload",
                        "ahn4-resident-step", "--seed", str(SEED),
                        "--seconds", "0.3"],
                       capture_output=True, text=True, cwd=CHECKOUT,
                       timeout=170)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().split("\n")[-1])
    assert out["correct"] and out["device"]["count"] == 1
    assert "ranks" not in out["window"]
    watched = p.stderr.strip().split("\n")[-1]
    assert watched == "WATCHED [{'children': 0, 'group': False}]", \
        p.stderr[-2000:]


# ---- on the card ---------------------------------------------------------

@pytest.mark.card
@pytest.mark.time_limit(300)
def test_probe_on_four_cards_through_run_py(tmp_path):
    """The probe through ``run.py`` on four cards: one rank a card, every
    card counted, untraced and traced; a rank killed in its fourth unit
    ends the run with no result.  With fewer cards ``run.py`` exits with
    code 3."""
    need_card()
    root = probe_checkout(tmp_path, CELLS)
    cmd = [sys.executable, "benchmark/run.py", "--seed", str(SEED),
           "--seconds", "2", "--trace", "0", "--workload"]
    p = subprocess.run(cmd + ["probe"], capture_output=True, text=True,
                       cwd=root, timeout=250)
    if torch.cuda.device_count() < 4:
        assert p.returncode == 3, p.stderr[-2000:]
        assert not p.stdout.strip()
        return
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().split("\n")[-1])
    print(json.dumps(out))
    assert out["correct"], out["checks"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 4
    assert dev["kind"] == torch.cuda.get_device_name(0)
    ranks = out["window"]["ranks"]
    assert sorted(r["card"] for r in ranks) == [0, 1, 2, 3]
    assert all(r["memory_peak_bytes"] > 0 for r in ranks)
    p = subprocess.run(cmd[:-2] + ["1", "--workload", "probe"],
                       capture_output=True, text=True, cwd=root, timeout=250)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().split("\n")[-1])
    print(json.dumps(out))
    assert out["correct"] and out["device"]["count"] == 4
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for r in out["window"]["ranks"]:
        assert 0 < r["busy_s"] <= r["window_s"]
    t0 = time.monotonic()
    p = subprocess.run(cmd + ["probe-killed"], capture_output=True,
                       text=True, cwd=root, timeout=250)
    took = time.monotonic() - t0
    print(f"killed rank: exit {p.returncode} after {took:.1f} s\n"
          f"{p.stderr[-1500:]}")
    assert p.returncode == 5 and not p.stdout.strip()
    assert "exited with codes [-9]" in p.stderr


@pytest.mark.card
@pytest.mark.time_limit(300)
def test_world_of_one_on_the_card(tmp_path):
    """The rank path with a world of one on ``cuda:0``: NCCL starts, the
    probe's collectives run, and the device facts are the card's."""
    need_card()
    root = probe_checkout(tmp_path, CELLS)
    for trace in (False, True):
        out = run_probe(root, "probe", seconds=2.0, trace=trace, n=1,
                        device="cuda")
        print(json.dumps(out))
        assert out["correct"], out["checks"]
        dev = out["device"]
        assert dev["platform"] == "gpu" and dev["count"] == 1
        assert dev["kind"] == torch.cuda.get_device_name(0)
        assert dev["memory_peak_bytes"] > 0
        (rank,) = out["window"]["ranks"]
        assert rank["card"] == 0 and rank["memory_peak_bytes"] > 0
        if trace:
            assert 0 < dev["busy_s"] < dev["window_s"]
