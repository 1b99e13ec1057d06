"""A persistent JAX compilation cache of each test process's own.

The JAX package runs many small programs op by op (eager ``shard_map``,
Pallas in interpret mode). Each op is traced anew, and XLA compiles it again
though the same program came before. With the cache on, a program compiled
once is read back from disk: about 95 % of the compiles of
``tests/test_pipeline.py::test_pipeline_distributed_mode`` are such repeats.

Each process (each xdist worker) has a directory of its own, so no two
processes write one entry at once. The directories sit under one directory
of the run, which the process that made it removes when the run ends: no
run reads what an earlier run compiled.
"""

import os
import shutil
import sys
import tempfile

import pytest

#: the run's directory, passed to the processes the run starts
_RUN_DIR = "PASTURE_TESTS_JAX_CACHE"
_OWNED = pytest.StashKey()


def pytest_configure(config):
    if "jax" not in sys.modules:
        return  # a run that never imports the JAX package
    import jax

    run_dir = os.environ.get(_RUN_DIR)
    if run_dir is None:
        run_dir = os.environ[_RUN_DIR] = tempfile.mkdtemp(
            prefix="pytest-jax-cache-")
        config.stash[_OWNED] = run_dir
    jax.config.update("jax_compilation_cache_dir",
                      tempfile.mkdtemp(dir=run_dir))
    # every program, however small or quick to compile
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


def pytest_unconfigure(config):
    run_dir = config.stash.get(_OWNED, None)
    if run_dir is not None:
        shutil.rmtree(run_dir, ignore_errors=True)
        del os.environ[_RUN_DIR]
