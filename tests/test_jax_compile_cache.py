"""The run's own JAX compilation cache (``jax_compile_cache.py``), run on a
test of its own in a pytest of its own, as the suite runs."""

import os
import pathlib
import subprocess
import sys

_CONFTEST = '''
import jax

jax.config.update("jax_platforms", "cpu")
'''

_INNER = '''
import os
import pathlib

import jax
import jax.numpy as jnp


def test_each_program_is_written_once():
    cache = pathlib.Path(jax.config.jax_compilation_cache_dir)
    assert cache.parent == pathlib.Path(os.environ["PASTURE_TESTS_JAX_CACHE"])
    x = jnp.arange(5.0)
    first = jax.jit(lambda v: v * 3.0 + 1.0)(x)
    entries = sorted(cache.iterdir())
    assert entries
    # another function, the same program: its entry is the first's
    again = jax.jit(lambda v: v * 3.0 + 1.0)(x)
    assert sorted(cache.iterdir()) == entries
    assert jnp.array_equal(first, again)
    print("CACHE", cache)
'''


def test_each_run_compiles_into_a_cache_it_removes(tmp_path):
    (tmp_path / "conftest.py").write_text(_CONFTEST)
    (tmp_path / "test_inner.py").write_text(_INNER)
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).parent),
               PYTEST_DISABLE_PLUGIN_AUTOLOAD="1", TMPDIR=str(tmp_path))
    env.pop("PASTURE_TESTS_JAX_CACHE", None)
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "jax_compile_cache",
         "-p", "no:cacheprovider", "-s", "-q", "test_inner.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    out = run.stdout + run.stderr
    assert run.returncode == 0, out
    cache = pathlib.Path(out.split("CACHE ", 1)[1].split()[0])
    # the run's directory was under the run's TMPDIR, and is gone
    assert cache.parent.parent == tmp_path, out
    assert not cache.parent.exists(), out
