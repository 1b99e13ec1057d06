"""Point-cloud file I/O (parity: pasture-io).

Format backends register themselves with the default
:class:`~pasture_tpu_torch.io.base.IOFactory` at import, mirroring pasture's
extension dispatch (reference: pasture-io/src/base/io_factory.rs:22-166):
``.las``/``.laz`` -> LAS backend, ``.pnts`` -> 3D Tiles backend.  The ASCII
backend is importable but not in the factory (the reference keeps it out of
the factory because the format string is mandatory, io_factory.rs:36-40).
"""

from .base import (  # noqa: F401
    DEFAULT_FACTORY,
    IOFactory,
    Metadata,
    PointReader,
    PointWriter,
    SeekToPoint,
    open_reader,
    open_writer,
    point_count,
    read_all,
    read_all_appended,
    read_all_into,
    write_all,
)
from .ascii import AsciiReader, AsciiWriter  # noqa: F401
from .device import batch_positions, read_batch  # noqa: F401
from .las import LasReader, LasWriter  # noqa: F401
from .tiles3d import PntsReader, PntsWriter  # noqa: F401


def _register_formats() -> None:
    DEFAULT_FACTORY.register_reader("las", LasReader)
    DEFAULT_FACTORY.register_reader("laz", LasReader)
    DEFAULT_FACTORY.register_writer("las", LasWriter)
    DEFAULT_FACTORY.register_writer("laz", LasWriter)
    DEFAULT_FACTORY.register_reader("pnts", PntsReader)
    DEFAULT_FACTORY.register_writer("pnts", PntsWriter)


_register_formats()
from .streaming import (  # noqa: F401,E402
    stream_batches,
    streaming_bounds,
    streaming_voxel_downsample,
)
