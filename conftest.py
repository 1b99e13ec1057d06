"""pytest settings of every run from the repository's root, loaded before
``tests/conftest.py``:

- each test's own time limit, and the order xdist hands out the files in
  (``tests/time_limits.py``);
- a JAX compilation cache of each test process's own, removed at the end of
  the run (``tests/jax_compile_cache.py``).
"""

pytest_plugins = ["tests.time_limits", "tests.jax_compile_cache"]
