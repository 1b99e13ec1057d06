"""The per-test time limit (``time_limits.py``), run on tests of its own in
a pytest of its own under xdist, as the suite runs."""

import os
import pathlib
import subprocess
import sys
import time

_INNER = '''
import signal
import time

import pytest


@pytest.mark.time_limit(1)
def test_sleeps_past_its_limit():
    time.sleep(60)


@pytest.mark.time_limit(1)
def test_stuck_where_python_cannot_raise():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(60)


def test_runs_after_them():
    pass
'''


def test_time_limit_fails_the_test_and_the_run_goes_on(tmp_path):
    (tmp_path / "test_inner.py").write_text(_INNER)
    # only the plugins named below: the installed ones take seconds to load
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).parent),
               PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    start = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "time_limits", "-p", "xdist",
         "-n", "1", "-p", "no:cacheprovider",
         "-o", "markers=time_limit(seconds)", "-rA", str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    took = time.monotonic() - start
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "2 failed, 1 passed" in out, out
    # the alarm: the test fails with its limit named and every stack dumped
    assert "TimeLimitExceeded" in out, out
    assert "ran past its time limit of 1 s" in out, out
    assert "most recent call first" in out, out
    # the backstop: faulthandler ends the stuck worker, xdist replaces it
    assert "crashed while running" in out, out
    assert "test_stuck_where_python_cannot_raise" in out, out
    assert "PASSED test_inner.py::test_runs_after_them" in out, out
    assert took < 60, (took, out)
