"""The device rule of the port, stated once, and its matmul precision.

Entry points take ``device=None`` meaning "the card": it resolves to
``cuda`` and raises when no CUDA device is present.  Only an explicit
``device="cpu"`` runs on the CPU.  Functions on tensors follow their
inputs' device and never call this.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

__all__ = ["resolve_device", "fp32_matmul"]


@contextlib.contextmanager
def fp32_matmul() -> Iterator[None]:
    """Float32 matrix products in true fp32 inside the block (no TF32),
    whatever the caller set: pairwise distances by ``|q|² + |p|² - 2 q·p``
    lose the neighbourhood scale to TF32's 10-bit mantissa.  The setting
    is process-wide: public entry points enter this once per call, the
    helpers they call (per tile, per iteration) do not."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else -> ``torch.device(device)`` unchanged."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None means the GPU, and torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
