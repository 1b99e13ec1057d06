"""pasture_tpu_torch — the PyTorch/CUDA port of the point-cloud engine.

Same layer names as the JAX package it is ported from, so a reader finds
the counterpart of every module:

  layout -> buffers -> math -> ops -> ops.kernels; algorithms on top

* data lives as SoA :class:`~pasture_tpu_torch.buffers.PointBatch` dicts of
  torch tensors;
* plain tensor code is PyTorch; the hot per-point stages are CUDA C++
  kernels written for Hopper (``ops/kernels/csrc``), built by ``nvcc`` at
  their first launch — importing this package needs neither a GPU nor a
  CUDA toolchain;
* entry points take ``device=None`` meaning the GPU and raise without one;
  only an explicit ``device="cpu"`` runs on the CPU, where each kernel
  wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from . import algorithms, layout  # noqa: F401
from .buffers import HostPointBuffer, PointBatch  # noqa: F401
from .layout import PointAttribute, PointSchema  # noqa: F401
from .math import AABB  # noqa: F401
