"""Point buffers: host SoA/interleaved + device PointBatch (torch)."""

from .device import PointBatch
from .host import HostPointBuffer

__all__ = ["HostPointBuffer", "PointBatch"]
