"""Each test's own time limit, and the order xdist hands out the tests in.

A test may take ``DEFAULT_TIME_LIMIT`` seconds, setup to teardown, or the
seconds of its ``time_limit`` marker. When they pass, every thread's stack
is dumped and the test fails with ``TimeLimitExceeded``; the run goes on. A
test stuck where Python cannot raise (inside a compile or a collective) is
ended ``TIME_LIMIT_GRACE`` seconds later (at most its limit again) by
``faulthandler``, which dumps the stacks and exits the process: under xdist
that fails the test and starts a new worker.

xdist's ``--dist loadfile`` hands out whole files, by default the files
with the most tests first, so a slow file of one test would start last and
set the end of the run. Here the units of work that hold a test with a
``time_limit`` of its own go first, the longest limit first. A unit is a
file, but for the tests of ``APART``, which go out apart from the rest of
their file.

The test files of the JAX package are not edited, so their slow tests take
their limits from ``TIME_LIMITS`` here. The repository's ``conftest.py``
loads this plugin; ``-p time_limits`` loads it alone.
"""

import collections
import faulthandler
import os
import signal
import sys
import threading
import time

import pytest

#: Seconds a test may take, setup to teardown, unless marked ``time_limit``:
#: about three times the slowest unmarked test on a loaded tier-1 run.
DEFAULT_TIME_LIMIT = 180.0
#: Seconds past the limit (at most the limit itself) before a test that
#: cannot be interrupted ends its process.
TIME_LIMIT_GRACE = 30.0

#: ``time_limit`` seconds of the JAX package's tests that take over a
#: minute: about three times their time on a loaded tier-1 run (six
#: workers on eight cores), and at most 1 200 s, inside the run's 1 470 s.
TIME_LIMITS = {
    "tests/test_pipeline.py::test_pipeline_distributed_mode": 1200,
    "tests/test_pallas_kernels.py::"
    "test_exact_local_residual_path_matches_exact_f32": 1200,
    "tests/test_algorithms.py::test_scan_exact_normals_at_scale": 960,
    "tests/test_parallel.py::test_distributed_normals_matches_exact": 870,
    "tests/test_parallel.py::"
    "test_distributed_icp_partitioned_point_to_plane": 780,
    "tests/test_voxel_merge.py::test_mode_runs_randomized_oracle": 490,
    "tests/test_algorithms.py::test_normals_morton_window_matches_exact": 440,
    "tests/test_pallas_kernels.py::"
    "test_fused_voxel_head_matches_internal_path": 370,
    "tests/test_parallel.py::"
    "test_partitioned_icp_realistic_scene_halo_envelope": 230,
    "tests/test_parallel.py::"
    "test_distributed_icp_partitioned_matches_single_device": 190,
    "tests/test_algorithms.py::test_normals_morton_window_plane": 190,
    "tests/test_laz_tables.py::"
    "test_synthetic_full_coverage_roundtrip_and_exercise": 240,
    "tests/test_multihost.py::"
    "test_two_process_mesh_runs_distributed_pipeline": 190,
}

#: Tests that go out as one unit of work apart from the rest of their file,
#: so that no one file's share sets the end of the run.
APART = (
    "tests/test_parallel.py::test_distributed_icp_partitioned_point_to_plane",
    "tests/test_parallel.py::"
    "test_partitioned_icp_realistic_scene_halo_envelope",
    "tests/test_parallel.py::test_sharded_voxel_merged_exact_mode_runs",
)


def unit_of(nodeid):
    """The unit of work xdist's ``--dist loadfile`` hands ``nodeid`` out in."""
    if nodeid in APART:
        return APART[0]
    return nodeid.split("::")[0]


class TimeLimitExceeded(Exception):
    """A test ran past its time limit."""


_STDERR = pytest.StashKey()
_LIMIT = pytest.StashKey()
_DEADLINE = pytest.StashKey()


def pytest_configure(config):
    # stderr as it is before a test's output is captured, for the stacks
    # dumped when a process is ended
    config.stash[_STDERR] = os.fdopen(os.dup(sys.stderr.fileno()), "w")
    # xdist hands out the units in collection order, which
    # pytest_collection_modifyitems sets
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_unconfigure(config):
    faulthandler.cancel_dump_traceback_later()
    config.stash[_STDERR].close()


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class Scheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return unit_of(nodeid)

    return Scheduling(config, log)


def _own_time_limit(item):
    marker = item.get_closest_marker("time_limit")
    return float(marker.args[0]) if marker else None


def pytest_collection_modifyitems(items):
    """Units that hold a test with a ``time_limit`` of its own first, the
    longest limit first; then the others, the most tests first. The order
    of the tests within a unit is kept."""
    for item in items:
        if item.nodeid in TIME_LIMITS:
            item.add_marker(pytest.mark.time_limit(TIME_LIMITS[item.nodeid]))

    limit, count = collections.defaultdict(float), collections.Counter()
    for item in items:
        unit = unit_of(item.nodeid)
        limit[unit] = max(limit[unit], _own_time_limit(item) or 0.0)
        count[unit] += 1
    items.sort(key=lambda item: (-limit[unit_of(item.nodeid)],
                                 -count[unit_of(item.nodeid)]))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    limit = _own_time_limit(item) or DEFAULT_TIME_LIMIT
    item.stash[_LIMIT] = limit
    item.stash[_DEADLINE] = time.monotonic() + limit
    faulthandler.dump_traceback_later(
        limit + min(TIME_LIMIT_GRACE, limit), exit=True,
        file=item.config.stash[_STDERR])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _within_limit(item):
    """Run one phase of ``item`` with an alarm at the test's deadline."""
    if threading.current_thread() is not threading.main_thread():
        # a signal's handler runs on the main thread only
        return (yield)

    def on_alarm(signum, frame):
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise TimeLimitExceeded(
            f"{item.nodeid} ran past its time limit of "
            f"{item.stash[_LIMIT]:g} s")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL,
                     max(item.stash[_DEADLINE] - time.monotonic(), 1e-3))
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


pytest_runtest_setup = pytest.hookimpl(wrapper=True)(_within_limit)
pytest_runtest_call = pytest.hookimpl(wrapper=True)(_within_limit)
pytest_runtest_teardown = pytest.hookimpl(wrapper=True)(_within_limit)
