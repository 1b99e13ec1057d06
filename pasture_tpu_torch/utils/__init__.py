"""Auxiliary subsystems: profiling, checkpointing.

The reference has none of these (no tracing, no checkpoint/resume); the
JAX package adds them and the port keeps the same names.
"""

from .profiling import trace, roofline_estimate  # noqa: F401
from .checkpoint import load_pytree, save_pytree  # noqa: F401
