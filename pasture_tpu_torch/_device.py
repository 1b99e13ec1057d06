"""The device rule of the port, stated once.

Entry points take ``device=None`` meaning "the card": it resolves to
``cuda`` and raises when no CUDA device is present.  Only an explicit
``device="cpu"`` runs on the CPU.  Functions on tensors follow their
inputs' device and never call this.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


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
